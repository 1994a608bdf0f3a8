"""The port's Terasort (Algorithm S) against the reference, end to end,
on the CPU.

torch cannot reproduce the reference's ``jax.random`` stream, so the
tests rebuild the reference's per-object uniforms -- each machine's key
from ``split(key(seed), t)``, then a ``lax.scan`` of ``k, sub =
split(k); uniform(sub)``, as ``repro.core.sampling.algorithm_s`` draws
them -- and hand them to the port (``uniforms=``).  With the same draws,
``repro_torch.cluster.sort(..., algorithm="terasort", device="cpu")``
and ``repro.cluster.sort(..., algorithm="terasort")`` (Pallas kernels in
interpret mode, or the jnp backend) must agree bitwise: keys, values and
every AlphaKReport field.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from repro import cluster as jcluster
from repro.core import algorithm_s as j_algorithm_s
from repro_torch import cluster
from repro_torch.core import (algorithm_s, report_fields,
                              terasort_sample_count, terasort_workload_bound)
from repro_torch.core.terasort import boundary_index
from repro_torch.data import lidar_like, uniform_keys


def reference_uniforms(seed: int, t: int, m: int) -> np.ndarray:
    """The (t, m) uniforms the reference's Algorithm S draws."""
    def machine(key):
        def step(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub)
        return lax.scan(step, key, None, length=m)[1]
    keys = jax.random.split(jax.random.key(seed), t)
    return np.array(jax.vmap(machine)(keys))


def assert_reports_equal(got, want):
    g, w = report_fields(got), report_fields(want)
    assert [p[0] for p in g["phases"]] == [p[0] for p in w["phases"]]
    for (_, gs, gr), (_, ws, wr) in zip(g["phases"], w["phases"]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)
    for key in ("algorithm", "n_in", "n_out", "alpha", "k_workload",
                "k_network", "cap_factor", "capacity_attempts"):
        assert g[key] == w[key], key
    np.testing.assert_array_equal(g["workload"], w["workload"])
    for key in ("theoretical_workload_bound", "exchange_topology",
                "total_dropped"):
        assert getattr(got, key) == getattr(want, key), key


# ---------------------------------------------------------------------------
# Algorithm S
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,q", [(100, 7), (40, 39), (300, 20), (8, 8)])
def test_algorithm_s_matches_reference(m, q):
    t, seed = 3, m + q
    x = np.random.default_rng(m).permutation(m * t).astype(np.float32)
    x = x.reshape(t, m)
    keys = jax.random.split(jax.random.key(seed), t)
    want = np.stack([np.asarray(j_algorithm_s(keys[i], jnp.asarray(x[i]), q))
                     for i in range(t)])
    got = algorithm_s(torch.from_numpy(x), q,
                      torch.from_numpy(reference_uniforms(seed, t, m)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_algorithm_s_takes_exactly_q_in_position_order():
    t, m, q = 5, 64, 9
    x = torch.arange(t * m, dtype=torch.float32).reshape(t, m)
    g = torch.Generator().manual_seed(3)
    got = algorithm_s(x, q, torch.rand((t, m), generator=g))
    assert got.shape == (t, q)
    assert torch.all(got[:, 1:] > got[:, :-1])              # distinct, in order
    # uniforms just below 1 take nothing until the take is forced: the
    # last q objects
    late = algorithm_s(x, q, torch.full((t, m), 0.99999994))
    np.testing.assert_array_equal(late.numpy(), x[:, m - q:].numpy())
    # uniforms of 0 take the first q
    early = algorithm_s(x, q, torch.zeros((t, m)))
    np.testing.assert_array_equal(early.numpy(), x[:, :q].numpy())


@pytest.mark.parametrize("t", [3, 6, 64, 100, 250])
def test_round2_index_is_the_reference_float32_division(t):
    """The oracle is jitted, as the Terasort body always runs: XLA turns
    the division by the constant t into a product with float32(1/t),
    which at t = 250 (and 7, 13, 14, 15) moves some indices one up from
    the eager division's (ROADMAP C18)."""
    s_tot = t * terasort_sample_count(t * 65536, t)
    want = np.asarray(jax.jit(lambda z: jnp.ceil(
        (jnp.arange(1, t) + z) * s_tot / t).astype(jnp.int32) - 1)(0))
    np.testing.assert_array_equal(boundary_index(t, s_tot, "cpu").numpy(),
                                  want)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

CASES = [(t, gen, with_values) for t in (4, 8)
         for gen in (uniform_keys, lidar_like) for with_values in (False, True)]


# t = 6: a machine count that is not a power of two, for Round 2's index
@pytest.mark.parametrize("t, gen, with_values",
                         CASES + [(6, lidar_like, True)])
def test_terasort_matches_reference(t, gen, with_values):
    m, seed = 1024, t + 1
    x = gen(t * m, seed=t).reshape(t, m)
    v = (np.random.default_rng(t).integers(0, 1 << 30, (t, m, 3))
         .astype(np.int32) if with_values else None)
    # Pallas interpret mode for the uniform keys, the jnp backend else
    backend = "pallas" if gen is uniform_keys else "reference"
    (wk, wv), want = jcluster.sort(x, algorithm="terasort", seed=seed,
                                   values=v, kernel_backend=backend)
    (gk, gv), rep = cluster.sort(x, algorithm="terasort", seed=seed,
                                 values=v, device="cpu",
                                 uniforms=reference_uniforms(seed, t, m))
    np.testing.assert_array_equal(gk.numpy().view(np.int32),
                                  np.asarray(wk).view(np.int32))
    np.testing.assert_array_equal(gk.numpy(), np.sort(x.reshape(-1)))
    if with_values:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    else:
        assert gv is None and wv is None
    assert_reports_equal(rep, want)
    assert rep.alpha == 3
    assert max(rep.workload) <= terasort_workload_bound(t * m, t)


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("t,m", [(7, 1024), (13, 256)])
def test_terasort_where_the_round2_index_rounds_up_matches_reference(
        t, m, with_values):
    """ROADMAP C18: at t = 7 and 13 the reference's jitted Round 2 takes
    some boundaries one sample later than an exact division would; on
    the reference's draws keys, values, workload, k_workload and every
    phase equal the reference's."""
    x = uniform_keys(t * m, seed=t).reshape(t, m)
    v = (np.random.default_rng(t).integers(0, 1 << 30, (t, m))
         .astype(np.int32) if with_values else None)
    seed = t + 1
    (wk, wv), want = jcluster.sort(x, algorithm="terasort", seed=seed,
                                   values=v, kernel_backend="reference")
    (gk, gv), rep = cluster.sort(x, algorithm="terasort", seed=seed,
                                 values=v, device="cpu",
                                 uniforms=reference_uniforms(seed, t, m))
    np.testing.assert_array_equal(gk.numpy().view(np.int32),
                                  np.asarray(wk).view(np.int32))
    if with_values:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert_reports_equal(rep, want)


def test_terasort_capacity_retry_matches_reference():
    """A first capacity far below Theorem 3: the retry loop doubles it
    until nothing drops, in the same steps as the reference."""
    t, m, seed = 4, 1024, 7
    x = uniform_keys(t * m, seed=1).reshape(t, m)
    (wk, _), want = jcluster.sort(
        x, algorithm="terasort", seed=seed, kernel_backend="reference",
        policy=jcluster.CapacityPolicy(base_factor=0.3, slack=1.0))
    (gk, _), rep = cluster.sort(
        x, algorithm="terasort", seed=seed, device="cpu",
        policy=cluster.CapacityPolicy(base_factor=0.3, slack=1.0),
        uniforms=reference_uniforms(seed, t, m))
    assert rep.capacity_attempts == want.capacity_attempts >= 2
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    assert_reports_equal(rep, want)


@pytest.mark.parametrize("t,m", [(4, 1024), (8, 333)])
def test_terasort_own_draws_sort_correctly(t, m):
    x = lidar_like(t * m, seed=m).reshape(t, m)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    (keys, vals), rep = cluster.sort(x, algorithm="terasort", seed=11,
                                     values=v, device="cpu")
    np.testing.assert_array_equal(keys.numpy(), np.sort(x.reshape(-1)))
    np.testing.assert_array_equal(vals.numpy(),
                                  np.argsort(x.reshape(-1), kind="stable"))
    assert rep.alpha == 3 and rep.capacity_attempts == 1
    interior = rep.boundaries[1:-1]
    cuts = np.searchsorted(keys.numpy(), interior, side="left")
    np.testing.assert_array_equal(
        rep.workload, np.diff(np.concatenate([[0], cuts, [t * m]])))
    # a different seed draws other samples; the sort is the same
    (keys2, _), rep2 = cluster.sort(x, algorithm="terasort", seed=12,
                                    device="cpu")
    np.testing.assert_array_equal(keys2.numpy(), keys.numpy())
    assert not np.array_equal(rep2.boundaries, rep.boundaries)


def test_terasort_refuses_what_the_reference_refuses():
    x = np.ones((2, 8), np.float32)
    with pytest.raises(ValueError, match="uniforms"):
        cluster.sort(x, algorithm="terasort", uniforms=np.zeros((2, 7)),
                     device="cpu")
    with pytest.raises(ValueError, match="unknown exchange topology"):
        cluster.sort(x, algorithm="terasort", exchange="ring", device="cpu")
    with pytest.raises(ValueError, match="unknown exchange topology"):
        jcluster.sort(x, algorithm="terasort", exchange="ring")


# ---------------------------------------------------------------------------
# On the card: the CUDA run equals the CPU run on the same draws
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,m", [(8, 4096), (4, 16384)])
def test_cuda_terasort_equals_cpu(card, t, m):
    """The in-tile merge at t = 8 and the rank merge at t = 4 (landed
    rows of 4 x 32,768 padded slots)."""
    x = uniform_keys(t * m, seed=5).reshape(t, m)
    v = np.random.default_rng(5).integers(0, 1 << 30, (t, m, 2)) \
        .astype(np.int32)
    u = torch.rand((t, m), generator=torch.Generator().manual_seed(5))
    (gk, gv), rep = cluster.sort(x, algorithm="terasort", values=v,
                                 uniforms=u)
    (wk, wv), want = cluster.sort(x, algorithm="terasort", values=v,
                                  uniforms=u, device="cpu")
    assert gk.is_cuda and gv.is_cuda
    np.testing.assert_array_equal(gk.cpu().numpy(), wk.numpy())
    np.testing.assert_array_equal(gv.cpu().numpy(), wv.numpy())
    assert_reports_equal(rep, want)
