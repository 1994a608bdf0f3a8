"""The port's SMMS path against the reference, end to end, on the CPU.

The same seeded numpy inputs go through ``repro.cluster.sort(...,
algorithm="smms")`` (with the Pallas kernels in interpret mode and with
the jnp reference backend) and ``repro_torch.cluster.sort(...,
device="cpu")`` (the kernels' plain versions).  Keys, values and every
AlphaKReport field must agree bitwise.  Template:
tests/test_cluster_kernel_parity.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro.core import boundaries_jax, equidepth_samples as j_equidepth
from repro_torch import cluster
from repro_torch.cluster import CollectiveTape
from repro_torch.core import (PAD, boundaries, boundaries_oracle,
                              equidepth_samples, flat_receive_capacity,
                              report_fields)
from repro_torch.data import lidar_like, uniform_keys, zipf_keys
from repro_torch.kernels import ops


def assert_reports_equal(got, want):
    g, w = report_fields(got), report_fields(want)
    assert g["alpha"] == w["alpha"] == 3
    np.testing.assert_array_equal(g["workload"], w["workload"])
    assert g["k_workload"] == w["k_workload"]
    assert g["k_network"] == w["k_network"]
    assert [p[0] for p in g["phases"]] == [p[0] for p in w["phases"]]
    for (_, gs, gr), (_, ws, wr) in zip(g["phases"], w["phases"]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)
    assert g["cap_factor"] == w["cap_factor"]
    assert g["capacity_attempts"] == w["capacity_attempts"]


def adversarial_shards(rng, t, m) -> np.ndarray:
    """Machine i holds only cluster (i+1) % t: every machine ships its
    whole shard to one destination (tests/test_capacity_retry.py)."""
    c = [np.sort(rng.uniform(k + 0.1, k + 0.2, m)).astype(np.float32)
         for k in range(t)]
    return np.stack([c[(i + 1) % t] for i in range(t)])


# ---------------------------------------------------------------------------
# CollectiveTape
# ---------------------------------------------------------------------------

def test_tape_phases_and_counts():
    t, c = 4, 3
    tape = CollectiveTape()
    with tape.phase("gather"):
        lam = torch.arange(t * c, dtype=torch.float32).reshape(t, c)
        assert tape.all_gather(lam) is lam
    with tape.phase("empty round"):
        pass
    with tape.phase("shuffle"):
        tiles = torch.full((t, t, 2), PAD)
        tiles[0, 1, 0] = 5.0           # machine 0 sends one object to 1
        tiles[2, 1, :] = 7.0           # machine 2 sends two objects to 1
        tiles[3, 3, 0] = 1.0           # machine 3 keeps one object
        landed = tape.all_to_all(tiles, sent=torch.tensor([1, 0, 2, 0]),
                                 pad=PAD)
        assert torch.equal(landed, tiles.transpose(0, 1))
        total = tape.psum(torch.tensor([1, 2, 3, 4]))
        assert int(total) == 10
    phases = tape.phases(t)
    assert [p.name for p in phases] == ["gather", "empty round", "shuffle"]
    np.testing.assert_array_equal(phases[0].sent, [c] * t)
    np.testing.assert_array_equal(phases[0].received, [t * c] * t)
    np.testing.assert_array_equal(phases[1].sent, [0] * t)
    np.testing.assert_array_equal(phases[2].sent, [1, 0, 2, 0])
    np.testing.assert_array_equal(phases[2].received, [0, 3, 0, 1])
    rep = tape.report(algorithm="x", t=t, n_in=8, n_out=8,
                      workload=np.array([0, 3, 0, 1]))
    assert rep.alpha == 3


def test_tape_all_to_all_takes_a_received_count():
    """``received=`` gives the landed count of tiles with no sentinel
    (the MoE return trip's dense rows) and wins over ``pad``, as in the
    reference's tape."""
    t = 3
    tape = CollectiveTape()
    tiles = torch.zeros((t, t, 2, 4))
    with tape.phase("return"):
        back = tape.all_to_all(tiles, sent=torch.tensor([2, 0, 1]),
                               received=torch.tensor([1, 1, 1]))
        tape.all_to_all(tiles, sent=torch.tensor([0, 0, 0]), pad=PAD,
                        received=torch.tensor([4, 0, 0]))
    assert torch.equal(back, tiles.transpose(0, 1))
    (phase,) = tape.phases(t)
    np.testing.assert_array_equal(phase.sent, [2, 0, 1])
    np.testing.assert_array_equal(phase.received, [5, 1, 1])


# ---------------------------------------------------------------------------
# Round 1 samples and Round 2 boundaries
# ---------------------------------------------------------------------------

def _sorted_rows(gen, t, m, seed):
    return np.sort(gen(t * m, seed=seed).reshape(t, m), axis=1)


# t = 7 and 13: machine counts whose float32 reciprocal XLA's rewrite
# of the index's division rounds up (ROADMAP C18); at (7, 100) the last
# sample's index lands past the row and takes jnp.take's NaN fill
@pytest.mark.parametrize("t,m,r", [(2, 7, 2), (4, 192, 2), (8, 1000, 3),
                                   (8, 64, 1), (7, 100, 2), (13, 200, 2)])
@pytest.mark.parametrize("gen", [uniform_keys, lidar_like, zipf_keys])
def test_samples_and_boundaries_bitwise(t, m, r, gen):
    s = r * t
    xs = _sorted_rows(gen, t, m, seed=t + m + r)
    lam = equidepth_samples(torch.from_numpy(xs), s)
    # jitted, as the SMMS body runs it: XLA multiplies by 1/s (C18)
    want_lam = np.asarray(jax.jit(jax.vmap(lambda row: j_equidepth(row, s)))(
        jnp.asarray(xs)))
    np.testing.assert_array_equal(lam.numpy().view(np.int32),
                                  want_lam.view(np.int32))
    # as the SMMS body runs it: jitted, every machine computing it
    want = np.asarray(jax.jit(jax.vmap(
        lambda z: boundaries_jax(jnp.asarray(want_lam) + z, m, s)))(
            jnp.zeros(t, jnp.float32)))[0]
    got = boundaries(lam, m, s).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("t,r", [(16, 2), (64, 2)])
def test_boundaries_close_at_wide_t(t, r):
    """Past t = 12 XLA's CPU sums the machines' CDFs in vectorised
    lanes, not in machine order; the port's boundaries then agree to a
    relative 1e-6 (a few float32 ulps)."""
    m, s = 256, r * t
    xs = _sorted_rows(uniform_keys, t, m, seed=t)
    lam = equidepth_samples(torch.from_numpy(xs), s)
    want = np.asarray(jax.jit(jax.vmap(
        lambda z: boundaries_jax(jnp.asarray(lam.numpy()) + z, m, s)))(
            jnp.zeros(t, jnp.float32)))[0]
    np.testing.assert_allclose(boundaries(lam, m, s).numpy(), want,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("t,r", [(4, 2), (8, 2), (16, 3)])
@pytest.mark.parametrize("gen", [uniform_keys, lidar_like])
def test_boundaries_vs_oracle(t, r, gen):
    """Same tolerance as the reference's own oracle test."""
    m, s = 512, r * t
    xs = _sorted_rows(gen, t, m, seed=t + r)
    lam = equidepth_samples(torch.from_numpy(xs), s)
    b_ref = boundaries_oracle(lam.numpy(), m, s)
    got = boundaries(lam, m, s).numpy()
    scale = np.max(np.abs(b_ref)) + 1.0
    np.testing.assert_allclose(got, b_ref, rtol=0, atol=2e-5 * scale)


# ---------------------------------------------------------------------------
# SMMS end to end
# ---------------------------------------------------------------------------

def _inputs(gen, t, m, rng):
    if gen == "uniform":
        return uniform_keys(t * m, seed=t + m).reshape(t, m)
    if gen == "zipf":
        return zipf_keys(t * m, seed=t * m).reshape(t, m)
    return adversarial_shards(rng, t, m)


@pytest.mark.parametrize("kernel_backend", ["pallas", "reference"])
@pytest.mark.parametrize("gen", ["uniform", "zipf", "adversarial"])
@pytest.mark.parametrize("t,m", [(4, 192), (8, 200)])
def test_smms_matches_reference(rng, t, m, gen, kernel_backend):
    x = _inputs(gen, t, m, rng)
    (want, _), want_rep = jcluster.sort(jnp.asarray(x), algorithm="smms",
                                        kernel_backend=kernel_backend)
    (got, vals), rep = cluster.sort(x, algorithm="smms", device="cpu")
    assert vals is None and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(got.numpy(), np.sort(x.reshape(-1)))
    assert_reports_equal(rep, want_rep)
    assert rep.exchange_topology == want_rep.exchange_topology == "flat"
    assert rep.theoretical_workload_bound == \
        want_rep.theoretical_workload_bound
    assert max(rep.workload) <= rep.theoretical_workload_bound
    if gen == "adversarial":
        assert rep.capacity_attempts >= 2


def test_adversarial_placement_forces_exactly_one_retry(rng):
    t, m = 4, 64
    x = adversarial_shards(rng, t, m)
    (keys, _), rep = cluster.sort(x, device="cpu")
    assert rep.capacity_attempts == 2
    base = cluster.CapacityPolicy.smms(t * m, t, 2)
    assert rep.cap_factor == pytest.approx(base.first_factor * base.growth)
    np.testing.assert_array_equal(keys.numpy(), np.sort(x.reshape(-1)))


def test_explicit_cap_factor_pins_buffer_and_raises(rng):
    x = adversarial_shards(rng, 4, 64)
    with pytest.raises(cluster.CapacityOverflowError):
        cluster.sort(x, cap_factor=1.5, device="cpu")


def test_smms_takes_the_rank_merge_past_one_tile():
    """t = 4, m = 32768 pads each receive buffer to 4 x 32768 slots,
    past MAX_KERNEL_LANES: the receive merge is the rank merge, with the
    bound rows blocked."""
    t, m = 4, 32768
    x = uniform_keys(t * m, seed=5).reshape(t, m)
    ops.reset_dispatch_counts()
    (keys, _), rep = cluster.sort(torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(keys.numpy(), np.sort(x.reshape(-1)))
    cap_pair = flat_receive_capacity(m, t, rep.cap_factor) // t
    assert not ops._merge_fits_one_tile(t, cap_pair)
    assert cap_pair > ops.RANK_MERGE_BOUND_BLOCK
    assert ops.DISPATCH_COUNTS[("merge_sorted_rows", "plain")] == 1
    assert int(rep.workload.sum()) == t * m


# ---------------------------------------------------------------------------
# SMMS with values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel_backend, trailing", [("pallas", ()),
                                                      ("reference", (3,))])
@pytest.mark.parametrize("gen", ["uniform", "zipf", "adversarial"])
@pytest.mark.parametrize("t,m", [(4, 192), (8, 200)])
def test_smms_with_values_matches_reference(rng, t, m, gen, trailing,
                                            kernel_backend):
    """Both value shapes and both reference backends (the reference's
    backends agree bitwise with each other, tests/test_cluster_kernel_
    parity.py), each value shape against one of them to keep the Pallas
    interpret-mode compiles few."""
    x = _inputs(gen, t, m, rng)
    v = rng.integers(-1000, 1000, (t, m) + trailing).astype(np.int32)
    (want, want_v), want_rep = jcluster.sort(
        jnp.asarray(x), algorithm="smms", values=jnp.asarray(v),
        kernel_backend=kernel_backend)
    (got, got_v), rep = cluster.sort(x, algorithm="smms", values=v,
                                     device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert got_v.shape == (t * m,) + trailing
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    order = np.argsort(x.reshape(-1), kind="stable")
    np.testing.assert_array_equal(got_v.numpy(),
                                  v.reshape((t * m,) + trailing)[order])
    assert_reports_equal(rep, want_rep)
    if gen == "adversarial":
        assert rep.capacity_attempts >= 2


def test_smms_with_values_through_the_rank_merge():
    """t = 4, m = 32768: the receive merge is the rank merge, whose
    scattered order channel carries the values."""
    t, m = 4, 32768
    x = zipf_keys(t * m, seed=3).reshape(t, m)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    ops.reset_dispatch_counts()
    (keys, vals), rep = cluster.sort(x, values=v, device="cpu")
    order = np.argsort(x.reshape(-1), kind="stable")
    np.testing.assert_array_equal(vals.numpy(), order)
    np.testing.assert_array_equal(keys.numpy(), x.reshape(-1)[order])
    cap_pair = flat_receive_capacity(m, t, rep.cap_factor) // t
    assert not ops._merge_fits_one_tile(t, cap_pair)
    assert ops.DISPATCH_COUNTS[("merge_sorted_rows_kv", "plain")] == \
        rep.capacity_attempts


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("t,m", [(7, 100), (7, 1000), (13, 260), (13, 1040)])
def test_smms_where_the_sample_index_rounds_up_matches_reference(
        t, m, with_values):
    """ROADMAP C18: at t = 7 and 13 the float32 reciprocal of s = 2t
    rounds up, and the reference's jitted body takes some samples one
    later than an exact division would (at (7, 100) the last one past
    the row: NaN).  Keys, values, workload, k_workload and every phase
    equal the reference's."""
    x = np.random.default_rng(t * m).uniform(-1e3, 1e3, (t, m)).astype(
        np.float32)
    v = (np.arange(t * m, dtype=np.int32).reshape(t, m) if with_values
         else None)
    (want, want_v), want_rep = jcluster.sort(
        jnp.asarray(x), algorithm="smms", values=v,
        kernel_backend="reference")
    (got, got_v), rep = cluster.sort(x, algorithm="smms", values=v,
                                     device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    if with_values:
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert_reports_equal(rep, want_rep)


def test_smms_at_sixteen_machines_matches_reference():
    """Past t = 12 the boundaries agree with the reference's to rtol
    1e-6 only (ROADMAP C5); end to end, keys and every report field are
    still bitwise the reference's at t = 16, m = 128."""
    t, m = 16, 128
    x = uniform_keys(t * m, seed=t).reshape(t, m)
    (want, _), want_rep = jcluster.sort(jnp.asarray(x), algorithm="smms")
    (got, _), rep = cluster.sort(x, algorithm="smms", device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert_reports_equal(rep, want_rep)
