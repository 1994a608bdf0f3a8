"""The port's RandJoin against the reference, end to end, on the CPU,
and the collectives on one axis of its machine grid.

torch cannot reproduce the reference's ``jax.random`` draws, so the
tests rebuild them -- machine (i, j)'s key is ``split(key(seed),
t).reshape(a, b)[i, j]``, split once more into an S and a T key, each
drawing ``randint`` rows or columns -- and hand them to the port
(``assignments=``).  With the same draws the outputs and every report
field must agree bitwise with ``repro.cluster.join(...,
algorithm="randjoin")``, on the paper's Zipf and scalar-skew tables cut
to small sizes.  The reference's outputs are (a, b, ...) arrays; the
port's are machine-major (t, ...), machine i*b + j for (i, j).
"""
import numpy as np
import jax
import pytest
import torch

from repro import cluster as jcluster
from repro_torch import cluster
from repro_torch.cluster import CollectiveTape
from repro_torch.core import choose_ab, report_fields
from repro_torch.data import scalar_skew_tables, zipf_tables

OUTPUT_FIELDS = ("s_rows", "t_rows", "valid", "count", "dropped")


def tables(kind: str):
    if kind == "zipf":
        s, t = zipf_tables(600, 500, theta=0.3, seed=1, domain=50)
    else:
        s, t = scalar_skew_tables(512, 60, 40, seed=2)
    s_rows = np.arange(len(s), dtype=np.int32)
    t_rows = np.arange(len(t), dtype=np.int32) + 100_000
    return s, s_rows, t, t_rows


def reference_assignments(seed, t, a, b, ms, mt):
    """The reference's draws: S rows (t, ms) and T columns (t, mt)."""
    def machine(key):
        key_s, key_t = jax.random.split(key)
        return (jax.random.randint(key_s, (ms,), 0, a),
                jax.random.randint(key_t, (mt,), 0, b))
    keys = jax.random.split(jax.random.key(seed), t)
    i_assign, j_assign = jax.vmap(machine)(keys)
    return np.array(i_assign, np.int32), np.array(j_assign, np.int32)


def injected(seed, t_machines, ab, s, t):
    a, b = ab if ab is not None else choose_ab(t_machines, len(s), len(t))
    tm = a * b
    return reference_assignments(seed, tm, a, b, -(-len(s) // tm),
                                 -(-len(t) // tm))


def assert_outputs_equal(got, want):
    for field in OUTPUT_FIELDS:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w.reshape(g.shape), err_msg=field)


def assert_join_reports_equal(got, want):
    g, w = report_fields(got), report_fields(want)
    assert [p[0] for p in g["phases"]] == [p[0] for p in w["phases"]]
    for (_, gs, gr), (_, ws, wr) in zip(g["phases"], w["phases"]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)
    for key in ("algorithm", "n_in", "n_out", "alpha", "k_workload",
                "k_network", "cap_factor", "capacity_attempts"):
        assert g[key] == w[key], key
    np.testing.assert_array_equal(g["workload"], w["workload"])


def host_pairs(s, s_rows, t, t_rows) -> np.ndarray:
    """Every (s_row, t_row) pair with equal keys, as sorted int64 codes."""
    st = np.argsort(t, kind="stable")
    lo = np.searchsorted(t[st], s, side="left")
    cnt = np.searchsorted(t[st], s, side="right") - lo
    si = np.repeat(np.arange(len(s)), cnt)
    ti = st[np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(cnt.sum())]
    return np.sort(s_rows[si].astype(np.int64) << 32 | t_rows[ti])


def pairs_of(out) -> np.ndarray:
    v = out.valid.numpy()
    return np.sort(out.s_rows.numpy()[v].astype(np.int64) << 32
                   | out.t_rows.numpy()[v])


# ---------------------------------------------------------------------------
# Collectives on one axis of an (a, b) machine grid
# ---------------------------------------------------------------------------

def test_grid_all_to_all_lands_within_each_line():
    a, b = 2, 3
    t = a * b
    for axis, n in ((0, a), (1, b)):
        tape = CollectiveTape()
        tiles = torch.arange(t * n * 2, dtype=torch.float32).reshape(t, n, 2)
        tiles[0, 0] = np.inf                          # a pad slot
        with tape.phase("route"):
            out = tape.all_to_all(tiles, sent=torch.arange(t), pad=np.inf,
                                  grid=(a, b), axis=axis)
        for i in range(a):
            for j in range(b):
                dst = i * b + j
                for k in range(n):    # the line's k-th member sent it
                    src = k * b + j if axis == 0 else i * b + k
                    me = i if axis == 0 else j
                    assert torch.equal(out[dst, k], tiles[src, me])
        (phase,) = tape.phases(t)
        np.testing.assert_array_equal(phase.sent, np.arange(t))
        # every machine lands n tiles of 2 slots; the pad pair lands on 0
        np.testing.assert_array_equal(phase.received,
                                      [2 * n - 2] + [2 * n] * (t - 1))


def test_grid_all_gather_and_psum_run_over_one_line():
    a, b = 2, 3
    t = a * b
    x = torch.arange(t * 4, dtype=torch.int32).reshape(t, 4)
    counts = torch.tensor([1, 2, 3, 4, 5, 6])
    for axis in (0, 1):
        tape = CollectiveTape()
        with tape.phase("gather"):
            out = tape.all_gather(x, count=counts, grid=(a, b), axis=axis)
        assert out.shape == (t, (a, b)[axis], 4)
        line_sums = []
        for i in range(a):
            for j in range(b):
                members = ([k * b + j for k in range(a)] if axis == 0
                           else [i * b + k for k in range(b)])
                assert torch.equal(out[i * b + j], x[members])
                line_sums.append(int(counts[members].sum()))
        (phase,) = tape.phases(t)
        np.testing.assert_array_equal(phase.sent, counts.numpy())
        np.testing.assert_array_equal(phase.received, line_sums)
        np.testing.assert_array_equal(
            tape.psum(counts, grid=(a, b), axis=axis).numpy(), line_sums)
    # without a grid, the 1-D collectives as before
    assert tape.psum(counts) == 21
    assert tape.all_gather(x) is x


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_machines, ab", [(4, None), (6, None), (8, None),
                                            (8, (1, 8)), (8, (8, 1)),
                                            (6, (3, 2))])
@pytest.mark.parametrize("kind", ["zipf", "scalar_skew"])
def test_randjoin_matches_reference(kind, t_machines, ab):
    s, sr, t, tr = tables(kind)
    seed = t_machines + 3
    want, want_rep = jcluster.join(s, sr, t, tr, algorithm="randjoin",
                                   t_machines=t_machines, seed=seed, ab=ab,
                                   kernel_backend="reference")
    got, rep = cluster.join(s, sr, t, tr, algorithm="randjoin",
                            t_machines=t_machines, seed=seed, ab=ab,
                            assignments=injected(seed, t_machines, ab, s, t),
                            device="cpu")
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)
    np.testing.assert_array_equal(pairs_of(got), host_pairs(s, sr, t, tr))
    np.testing.assert_array_equal(got.valid.numpy().sum(1), rep.workload)
    assert int(got.dropped.max()) == 0 and rep.alpha == 1


def test_randjoin_matches_the_reference_pallas_kernels():
    s, sr, t, tr = tables("scalar_skew")
    want, want_rep = jcluster.join(s, sr, t, tr, algorithm="randjoin",
                                   t_machines=8, seed=1,
                                   kernel_backend="pallas")
    got, rep = cluster.join(s, sr, t, tr, algorithm="randjoin", t_machines=8,
                            seed=1, assignments=injected(1, 8, None, s, t),
                            device="cpu")
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)


def test_randjoin_explicit_capacity_drops_like_the_reference():
    s, sr, t, tr = tables("scalar_skew")
    kw = dict(algorithm="randjoin", t_machines=4, out_capacity=300, seed=2)
    want, want_rep = jcluster.join(s, sr, t, tr, kernel_backend="reference",
                                   **kw)
    got, rep = cluster.join(s, sr, t, tr, device="cpu",
                            assignments=injected(2, 4, None, s, t), **kw)
    assert int(got.dropped.max()) > 0
    assert report_fields(rep)["capacity_attempts"] is None   # no retry loop
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)


@pytest.mark.parametrize("in_cap_factor, out_cap_factor", [(4.0, 0.3),
                                                           (0.6, 1.05)])
def test_randjoin_default_capacity_retries_like_the_reference(
        in_cap_factor, out_cap_factor):
    """Too few output slots, or route tiles too narrow: the retry loop
    doubles the output capacity and grows the routes with it."""
    s, sr, t, tr = tables("zipf")
    kw = dict(algorithm="randjoin", t_machines=4, seed=4,
              in_cap_factor=in_cap_factor, out_cap_factor=out_cap_factor)
    want, want_rep = jcluster.join(s, sr, t, tr, kernel_backend="reference",
                                   **kw)
    got, rep = cluster.join(s, sr, t, tr, device="cpu",
                            assignments=injected(4, 4, None, s, t), **kw)
    assert rep.capacity_attempts == want_rep.capacity_attempts >= 2
    assert int(got.dropped.max()) == 0
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)


@pytest.mark.parametrize("t_machines", [4, 16])
@pytest.mark.parametrize("kind", ["zipf", "scalar_skew"])
def test_randjoin_own_draws_join_correctly(kind, t_machines):
    s, sr, t, tr = tables(kind)
    got, rep = cluster.join(s, sr, t, tr, algorithm="randjoin",
                            t_machines=t_machines, seed=9, device="cpu")
    np.testing.assert_array_equal(pairs_of(got), host_pairs(s, sr, t, tr))
    np.testing.assert_array_equal(got.count.numpy(), rep.workload)
    assert int(got.dropped.max()) == 0 and rep.alpha == 1
    assert rep.algorithm == "RandJoin(a={},b={})".format(
        *choose_ab(t_machines, len(s), len(t)))


def test_randjoin_refuses_misshapen_draws():
    s, sr, t, tr = tables("zipf")
    i_assign, j_assign = injected(0, 4, None, s, t)
    with pytest.raises(ValueError, match="assignments"):
        cluster.join(s, sr, t, tr, algorithm="randjoin", t_machines=4,
                     assignments=(i_assign[:, 1:], j_assign), device="cpu")


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
@pytest.mark.parametrize("kind", ["zipf", "scalar_skew"])
def test_cuda_randjoin_equals_cpu(card, kind):
    s, sr, t, tr = tables(kind)
    draws = injected(5, 8, None, s, t)
    got, rep = cluster.join(s, sr, t, tr, algorithm="randjoin", t_machines=8,
                            assignments=draws)
    want, want_rep = cluster.join(s, sr, t, tr, algorithm="randjoin",
                                  t_machines=8, assignments=draws,
                                  device="cpu")
    for field in OUTPUT_FIELDS:
        assert getattr(got, field).is_cuda
        np.testing.assert_array_equal(getattr(got, field).cpu().numpy(),
                                      getattr(want, field).numpy())
    assert_join_reports_equal(rep, want_rep)
