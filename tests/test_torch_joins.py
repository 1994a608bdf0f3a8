"""The port's joins against the reference, end to end, on the CPU.

The same seeded numpy tables go through ``repro.cluster.join(...,
algorithm=a)`` and ``repro_torch.cluster.join(..., algorithm=a,
device="cpu")`` for StatJoin (paper §4.3) and its two baselines,
repartition and broadcast, on the paper's §5.2 inputs (Zipf tables and
scalar skew) cut to small sizes.  Every output field, every report field
and, for StatJoin, the plan must agree bitwise.  The host planner and
routing of the port work on arrays where the reference loops; they are
held against the reference's own functions here too.
"""
import dataclasses
from importlib import import_module

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro_torch import cluster
from repro_torch.core import (MASKED_KEY, local_equijoin, report_fields,
                              statjoin_workload_bound)
from repro_torch.data import scalar_skew_tables, zipf_tables

# the modules, not the functions of the same name the packages export
jlocaljoin = import_module("repro.core.localjoin")
jstatjoin = import_module("repro.core.statjoin")
pstatjoin = import_module("repro_torch.core.statjoin")

OUTPUT_FIELDS = ("s_rows", "t_rows", "valid", "count", "dropped")


def tables(kind: str):
    if kind == "zipf":
        s, t = zipf_tables(600, 500, theta=0.3, seed=1, domain=50)
    else:
        s, t = scalar_skew_tables(512, 60, 40, seed=2)
    s_rows = np.arange(len(s), dtype=np.int32)
    t_rows = np.arange(len(t), dtype=np.int32) + 100_000
    return s, s_rows, t, t_rows


def assert_outputs_equal(got, want):
    for field in OUTPUT_FIELDS:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


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
    hi = np.searchsorted(t[st], s, side="right")
    cnt = hi - lo
    si = np.repeat(np.arange(len(s)), cnt)
    ti = st[np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(cnt.sum())]
    return np.sort(s_rows[si].astype(np.int64) << 32 | t_rows[ti])


def pairs_of(out) -> np.ndarray:
    v = out.valid.numpy()
    return np.sort(out.s_rows.numpy()[v].astype(np.int64) << 32
                   | out.t_rows.numpy()[v])


@pytest.mark.parametrize("algorithm", ["statjoin", "repartition", "broadcast"])
@pytest.mark.parametrize("kind", ["zipf", "scalar_skew"])
@pytest.mark.parametrize("t_machines", [4, 8])
def test_join_matches_reference(algorithm, kind, t_machines):
    s, sr, t, tr = tables(kind)
    want, want_rep = jcluster.join(s, sr, t, tr, algorithm=algorithm,
                                   t_machines=t_machines)
    got, rep = cluster.join(s, sr, t, tr, algorithm=algorithm,
                            t_machines=t_machines, device="cpu")
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)
    np.testing.assert_array_equal(pairs_of(got), host_pairs(s, sr, t, tr))
    np.testing.assert_array_equal(got.valid.numpy().sum(1), rep.workload)
    assert int(got.dropped.max()) == 0
    if algorithm == "statjoin":
        assert rep.theoretical_workload_bound == \
            want_rep.theoretical_workload_bound
        assert max(rep.workload) <= rep.theoretical_workload_bound
        assert ([dataclasses.astuple(r) for r in rep.plan]
                == [dataclasses.astuple(r) for r in want_rep.plan])


@pytest.mark.parametrize("small_side", ["s", "t"])
def test_broadcast_retries_and_small_side_match_reference(small_side):
    """A capacity too small for the first attempt: the retry loop doubles
    it, on both sides of the orientation."""
    s, sr, t, tr = tables("zipf")
    kw = dict(algorithm="broadcast", t_machines=4, out_cap_factor=0.3,
              small_side=small_side)
    want, want_rep = jcluster.join(s, sr, t, tr, **kw)
    got, rep = cluster.join(s, sr, t, tr, device="cpu", **kw)
    assert rep.capacity_attempts == want_rep.capacity_attempts >= 2
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)


@pytest.mark.parametrize("algorithm", ["statjoin", "repartition", "broadcast"])
def test_explicit_capacity_reports_drops_like_the_reference(algorithm):
    s, sr, t, tr = tables("scalar_skew")
    kw = dict(algorithm=algorithm, t_machines=4, out_capacity=300)
    want, want_rep = jcluster.join(s, sr, t, tr, **kw)
    got, rep = cluster.join(s, sr, t, tr, device="cpu", **kw)
    assert int(got.dropped.max()) > 0
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)


@pytest.mark.parametrize("algorithm", ["statjoin", "broadcast"])
def test_precomputed_statistics_give_the_same_join(algorithm):
    """``stats=`` skips the front door's own count of W (and StatJoin's
    statistics round on the host); the result is the same."""
    s, sr, t, tr = tables("zipf")
    stats = pstatjoin.collect_statistics(s, t)
    got, rep = cluster.join(s, sr, t, tr, algorithm=algorithm, t_machines=4,
                            stats=stats, device="cpu")
    want, want_rep = jcluster.join(s, sr, t, tr, algorithm=algorithm,
                                   t_machines=4)
    assert_outputs_equal(got, want)
    assert_join_reports_equal(rep, want_rep)


@pytest.mark.parametrize("seed", [0, 5])
def test_planner_and_routing_match_the_reference_at_wide_t(seed):
    """t = 64 on scalar-skew tables of 2^14 rows: thousands of
    rectangles, a split hot key, and the greedy small pool."""
    t = 64
    s, tt = scalar_skew_tables(1 << 14, 900, 700, seed=seed)
    stats = pstatjoin.collect_statistics(s, tt)
    plan = pstatjoin.plan_statjoin(stats, t)
    want = jstatjoin.plan_statjoin(jstatjoin.collect_statistics(s, tt), t)
    assert len(plan) > 5000
    assert [dataclasses.astuple(r) for r in plan] == \
        [dataclasses.astuple(r) for r in want]
    assert dataclasses.astuple(plan[7]) == dataclasses.astuple(want[7])
    loads = np.bincount(plan.machine, weights=(plan.s_hi - plan.s_lo)
                        * (plan.t_hi - plan.t_lo), minlength=t)
    assert loads.max() <= statjoin_workload_bound(stats.total, t)
    for keys, side in ((s, "s"), (tt, "t")):
        got, cap = pstatjoin._routing_tensors(keys, plan, t, side)
        ref, ref_cap = jstatjoin._routing_tensors(keys, want, t, side)
        assert cap == ref_cap
        np.testing.assert_array_equal(got, ref)


def test_local_equijoin_batched_equals_reference_per_machine(rng):
    t, ns, nt, cap = 3, 40, 50, 120
    sk = rng.integers(0, 6, (t, ns)).astype(np.int32)
    tk = rng.integers(0, 6, (t, nt)).astype(np.int32)
    sk[:, ::5] = MASKED_KEY
    tk[:, ::7] = MASKED_KEY
    sr = rng.integers(0, 1000, (t, ns)).astype(np.int32)
    tr = rng.integers(0, 1000, (t, nt)).astype(np.int32)
    got = local_equijoin(*(torch.from_numpy(a) for a in (sk, sr, tk, tr)),
                         cap)
    assert got.count.dtype == got.dropped.dtype == torch.int32
    for i in range(t):
        want = jlocaljoin.local_equijoin(
            *(jnp.asarray(a[i]) for a in (sk, sr, tk, tr)), cap)
        for field in OUTPUT_FIELDS:
            np.testing.assert_array_equal(getattr(got, field)[i].numpy(),
                                          np.asarray(getattr(want, field)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["statjoin", "repartition", "broadcast"])
def test_cuda_join_equals_cpu(card, algorithm):
    s, sr, t, tr = tables("scalar_skew")
    got, rep = cluster.join(s, sr, t, tr, algorithm=algorithm, t_machines=8)
    want, want_rep = cluster.join(s, sr, t, tr, algorithm=algorithm,
                                  t_machines=8, device="cpu")
    for field in OUTPUT_FIELDS:
        assert getattr(got, field).is_cuda
        np.testing.assert_array_equal(getattr(got, field).cpu().numpy(),
                                      getattr(want, field).numpy())
    assert_join_reports_equal(rep, want_rep)
