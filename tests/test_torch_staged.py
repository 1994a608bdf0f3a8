"""The port's staged exchange against the reference, on the CPU.

The staged exchange factors the t machines into a t1 x t2 grid and
replaces the flat t-way all-to-all by two ~sqrt(t)-way hops: to the
machine group over i1, a merge and a re-cut against the group's
boundaries, then to the machine over i2 in ``overlap_chunks`` slices,
each merged as it lands, then merged across slices.  Every test holds
the port bitwise against ``repro.cluster.sort(..., exchange="staged")``
(its jnp backend, or its Pallas kernels in interpret mode where it
says so): keys, values and every AlphaKReport field, the s1/s2 phases'
sent and received counts included; and against the port's own flat
run: the same keys and workload, one more round.  Terasort takes the
reference's draws (``uniforms=``).
"""
import functools
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro.cluster import VmapSubstrate
from repro.core import exchange as jexchange
from repro.launch import mesh as jmesh
from repro_torch import cluster
from repro_torch.cluster import CollectiveTape
from repro_torch.core import exchange
from repro_torch.data import lidar_like, uniform_keys, zipf_keys
from repro_torch.kernels import ops
from repro_torch.launch import STAGED_AXIS_NAMES, factor_shards

from test_torch_nan_paths import bits, nan_keys
from test_torch_terasort import assert_reports_equal, reference_uniforms

GENS = {"uniform": uniform_keys, "lidar": lidar_like, "zipf": zipf_keys}


def run_both(x, *, algorithm, values=None, seed=1, kernel_backend=None,
             **kw):
    """(port's (keys, values, report), reference's) of one sort."""
    t, m = x.shape
    (wk, wv), want = jcluster.sort(
        jnp.asarray(x), algorithm=algorithm, seed=seed,
        values=None if values is None else jnp.asarray(values),
        kernel_backend=kernel_backend, **kw)
    extra = ({"uniforms": reference_uniforms(seed, t, m)}
             if algorithm == "terasort" else {})
    (gk, gv), got = cluster.sort(x, algorithm=algorithm, values=values,
                                 seed=seed, device="cpu", **extra, **kw)
    return (gk, gv, got), (wk, wv, want)


def assert_same_run(got, want, with_values):
    gk, gv, grep = got
    wk, wv, wrep = want
    np.testing.assert_array_equal(bits(gk), bits(wk))
    if with_values:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    else:
        assert gv is None and wv is None
    assert_reports_equal(grep, wrep)


def assert_staged_is_flat(staged, flat, with_values):
    """Staged against flat: the same keys, workload and k_workload; one
    more round, the shuffle split into s1 and s2; values the same pairs
    (equal keys may order their values differently between the
    topologies, in the reference too)."""
    (sk, sv, srep), (fk, fv, frep) = staged, flat
    np.testing.assert_array_equal(bits(sk), bits(fk))
    np.testing.assert_array_equal(srep.workload, frep.workload)
    assert srep.k_workload == frep.k_workload
    assert (srep.exchange_topology, frep.exchange_topology) == ("staged",
                                                                "flat")
    assert srep.alpha == frep.alpha + 1
    names = [p.name for p in srep.phases]
    assert names == [p.name for p in frep.phases][:-1] + [
        "round3 shuffle s1", "round3 shuffle s2"]
    if with_values:
        k, sv, fv = sk.numpy(), sv.numpy(), fv.numpy()
        np.testing.assert_array_equal(sv[np.lexsort((sv, k))],
                                      fv[np.lexsort((fv, k))])


# ---------------------------------------------------------------------------
# the factorization and the relay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 3, 4, 6, 8, 12, 16, 100])
def test_factor_shards_matches_reference(t):
    want = jmesh.factor_shards(t)
    assert factor_shards(t) == want
    assert STAGED_AXIS_NAMES == jmesh.STAGED_AXIS_NAMES
    if want is None:
        with pytest.warns(UserWarning, match="flat"):
            assert factor_shards(t, warn=True) is None
    else:
        t1, t2 = want
        assert t1 * t2 == t and t1 >= t2 >= 2
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert factor_shards(t, warn=True) == want


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("t1,t2", [(2, 2), (4, 2)])
def test_relay_equals_flat_all_to_all_and_reference(t1, t2, chunks):
    """The pure relay (no restage): the stage-2 landing, reassembled
    source-major, is the flat all-to-all of the same buffer, and equals
    the reference's relay; each stage is its own phase."""
    t, c = t1 * t2, 4
    blocks = np.random.default_rng(t + chunks).normal(
        size=(t, t1, t2, c)).astype(np.float32)
    flat = CollectiveTape().all_to_all(torch.from_numpy(blocks.reshape(t, t,
                                                                       c)))
    tape = CollectiveTape()
    outs, _ = tape.staged_all_to_all(torch.from_numpy(blocks),
                                     grid=(t1, t2), chunks=chunks)
    staged = torch.cat([ok for ok, _ in outs], dim=2)          # (t, t2, t1*c)
    landed = staged.numpy().reshape(t1, t2, t2, t1, c)
    landed = landed.swapaxes(2, 3).reshape(t, t, c)
    np.testing.assert_array_equal(landed, flat.numpy())

    def body(buf, tape=None):
        o, _ = tape.staged_all_to_all(buf, STAGED_AXIS_NAMES, chunks=chunks)
        return jnp.concatenate([ok for ok, _ in o], axis=1)

    sub = VmapSubstrate((STAGED_AXIS_NAMES[0], t1), (STAGED_AXIS_NAMES[1], t2))
    want, jtape = sub.run(body, jnp.asarray(blocks.reshape(t1, t2, t1, t2, c)))
    np.testing.assert_array_equal(staged.numpy(),
                                  np.asarray(want).reshape(staged.shape))
    for p, q in zip(tape.phases(t), jtape.phases(t)):
        assert p.name == q.name
        np.testing.assert_array_equal(p.sent, q.sent)
        np.testing.assert_array_equal(p.received, q.received)
    assert [p.name for p in tape.phases(t)] == ["shuffle s1", "shuffle s2"]


def test_all_gather_multi_records_each_hop():
    t1, t2, c = 4, 2, 5
    x = torch.arange(t1 * t2 * c, dtype=torch.float32).reshape(t1 * t2, c)
    tape = CollectiveTape()
    with tape.phase("g"):
        assert tape.all_gather_multi(x, grid=(t1, t2)) is x

    def body(xl, tape=None):
        with tape.phase("g"):
            return tape.all_gather_multi(xl, STAGED_AXIS_NAMES)

    sub = VmapSubstrate((STAGED_AXIS_NAMES[0], t1), (STAGED_AXIS_NAMES[1], t2))
    out, jtape = sub.run(body, jnp.asarray(x.numpy().reshape(t1, t2, c)))
    np.testing.assert_array_equal(np.asarray(out)[0, 0].reshape(-1, c),
                                  x.numpy())
    [p], [q] = tape.phases(t1 * t2), jtape.phases(t1 * t2)
    np.testing.assert_array_equal(p.sent, q.sent)
    np.testing.assert_array_equal(p.received, q.received)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_receive_capacities_match_reference(chunks):
    for m, t1, t2, f in ((65536, 8, 8, 2.101), (65536, 8, 8, 5.5),
                         (512, 4, 2, 2.1), (100, 2, 2, 1.0)):
        assert exchange.staged_receive_capacities(m, t1, t2, f, chunks) == \
            jexchange.staged_receive_capacities(m, t1, t2, f, chunks)


# ---------------------------------------------------------------------------
# SMMS and Terasort, staged, against the reference and the flat run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("gen", sorted(GENS))
@pytest.mark.parametrize("t", [8, 16])
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_staged_sort_matches_reference_and_flat(algorithm, t, gen,
                                                with_values, chunks):
    m = 256
    x = GENS[gen](t * m, seed=t + chunks).reshape(t, m)
    v = (np.arange(t * m, dtype=np.int32).reshape(t, m) * 3 + 1
         if with_values else None)
    staged, want = run_both(x, algorithm=algorithm, values=v,
                            exchange="staged", overlap_chunks=chunks)
    assert_same_run(staged, want, with_values)
    assert staged[2].exchange_topology == "staged"
    (fk, fv), frep = cluster.sort(
        x, algorithm=algorithm, values=v, seed=1, device="cpu",
        **({"uniforms": reference_uniforms(1, t, m)}
           if algorithm == "terasort" else {}))
    assert_staged_is_flat(staged, (fk, fv, frep), with_values)


@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_staged_values_equal_flat_on_distinct_keys(algorithm):
    """With distinct keys the values are the flat run's, row for row."""
    t, m = 8, 256
    keys = np.random.default_rng(5).permutation(t * m).astype(
        np.float32).reshape(t, m)
    vals = np.arange(t * m, dtype=np.int32).reshape(t, m)
    kw = dict(algorithm=algorithm, values=vals, device="cpu",
              **({"uniforms": reference_uniforms(0, t, m)}
                 if algorithm == "terasort" else {}))
    (fk, fv), _ = cluster.sort(keys, **kw)
    (sk, sv), _ = cluster.sort(keys, exchange="staged", **kw)
    assert torch.equal(sk, fk) and torch.equal(sv, fv)
    order = np.argsort(keys.reshape(-1), kind="stable")
    np.testing.assert_array_equal(sv.numpy(), vals.reshape(-1)[order])


@pytest.mark.parametrize("algorithm,m", [("smms", 32768),
                                         ("terasort", 16384)])
def test_staged_rows_past_one_tile_take_the_rank_merge(algorithm, m):
    """t = 4 (2 x 2): the stage-1 landed rows pass 2^16 padded slots, so
    the restage merge and the cross-run merge are rank merges."""
    t = 4
    x = uniform_keys(t * m, seed=9).reshape(t, m)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    ops.reset_dispatch_counts()
    staged, want = run_both(x, algorithm=algorithm, values=v,
                            exchange="staged")
    assert_same_run(staged, want, True)
    rep = staged[2]
    c1 = -(-int(rep.cap_factor * m) // 2)
    assert not ops._merge_fits_one_tile(2, c1)
    assert ops.DISPATCH_COUNTS[("merge_sorted_rows_kv", "plain")] == 1 + 2 + 1


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
@pytest.mark.parametrize("case", ["mid_row", "mixed"])
def test_staged_sort_with_nan_keys_matches_reference(case, algorithm,
                                                     with_values):
    """t = 4 x 64 with NaN keys (as test_torch_nan_paths.py), staged 2 x 2,
    against the reference's Pallas kernels in interpret mode."""
    x = nan_keys(case)
    t, m = x.shape
    v = (np.arange(t * m, dtype=np.int32).reshape(t, m) * 7 + 3
         if with_values else None)
    got, want = run_both(x, algorithm=algorithm, values=v, seed=0,
                         kernel_backend="pallas", exchange="staged")
    assert_same_run(got, want, with_values)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

def test_non_power_of_two_t_warns_and_runs_flat():
    t, m = 6, 256
    x = uniform_keys(t * m, seed=4).reshape(t, m)
    with pytest.warns(UserWarning, match="flat"):
        (ks, _), rs = cluster.sort(x, exchange="staged", device="cpu")
    assert rs.exchange_topology == "flat" and rs.alpha == 3
    with pytest.warns(UserWarning, match="flat"):
        (wk, _), wrep = jcluster.sort(jnp.asarray(x), exchange="staged")
    np.testing.assert_array_equal(ks.numpy(), np.asarray(wk))
    assert_reports_equal(rs, wrep)


def test_unknown_exchange_raises_as_the_reference():
    x = np.ones((4, 8), np.float32)
    for sort in (functools.partial(cluster.sort, device="cpu"),
                 jcluster.sort):
        with pytest.raises(ValueError, match="unknown exchange topology"):
            sort(x, exchange="ring")


def test_staged_at_sixteen_machines_through_the_front_door():
    t, m = 16, 256
    x = uniform_keys(t * m, seed=6).reshape(t, m)
    (kf, _), rf = cluster.sort(x, exchange="flat", device="cpu")
    (ks, _), rs = cluster.sort(x, exchange="staged", device="cpu")
    assert torch.equal(kf, ks) and rs.exchange_topology == "staged"
    assert rs.alpha == rf.alpha + 1



@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_staged_bf16_keys_match_reference(algorithm):
    """bf16 keys: the restage searches bf16 rows with the float32 group
    boundaries (SMMS) as exact bf16 queries, per row."""
    t, m = 8, 256
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(t, m)).astype(np.float32)).bfloat16()
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    extra = ({"uniforms": reference_uniforms(0, t, m)}
             if algorithm == "terasort" else {})
    (gk, gv), got = cluster.sort(x, algorithm=algorithm, values=v,
                                 exchange="staged", device="cpu", **extra)
    (wk, wv), want = jcluster.sort(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        algorithm=algorithm, values=jnp.asarray(v), exchange="staged")
    np.testing.assert_array_equal(gk.view(torch.int16).numpy(),
                                  np.asarray(wk).view(np.int16))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert_reports_equal(got, want)
