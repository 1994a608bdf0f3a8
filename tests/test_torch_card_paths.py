"""The staged exchange, the planner, ``obs.timeit`` and the MoE dispatch
on the card.

Card-only (``-m cuda``; they skip without a card), in a file that does
not import JAX: the card's run is held against the same call on the
CPU (the kernels' plain versions) on the same inputs and draws.
"""
import numpy as np
import pytest
import torch

from repro_torch import cluster, obs, planner
from repro_torch.data import lidar_like, uniform_keys, zipf_tables


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_staged_sort_on_the_card_equals_the_cpu_run(card, algorithm):
    """t = 16 (4 x 4) with values, and t = 4 (2 x 2) past one tile: the
    card's staged run equals the CPU's on the same draws, bitwise."""
    for t, m in ((16, 4096), (4, 32768)):
        x = lidar_like(t * m, seed=t).reshape(t, m)
        v = np.arange(t * m, dtype=np.int32).reshape(t, m)
        u = torch.rand((t, m), generator=torch.Generator().manual_seed(t))
        kw = dict(algorithm=algorithm, values=v, exchange="staged",
                  uniforms=u if algorithm == "terasort" else None)
        (gk, gv), got = cluster.sort(x, **kw)
        (wk, wv), want = cluster.sort(x, device="cpu", **kw)
        assert gk.is_cuda and torch.equal(gk.cpu(), wk)
        assert torch.equal(gv.cpu(), wv)
        assert got.exchange_topology == want.exchange_topology == "staged"
        np.testing.assert_array_equal(got.workload, want.workload)
        for a, b in zip(got.phases, want.phases):
            assert a.name == b.name
            np.testing.assert_array_equal(a.sent, b.sent)
            np.testing.assert_array_equal(a.received, b.received)


@pytest.mark.cuda
def test_planner_on_the_card_equals_the_cpu(card):
    """The sketch round on the card gives the CPU's profile, bitwise, so
    the same plan; auto equals the named winner; the cache serves the
    second call."""
    planner.clear_plan_cache()
    x = uniform_keys(16 * 4096, seed=3).reshape(16, 4096)
    (ka, _), ra = cluster.sort(x, algorithm="auto", exchange="auto")
    planner.clear_plan_cache()
    (kc, _), rc = cluster.sort(x, algorithm="auto", exchange="auto",
                               device="cpu")
    for f in ("algorithm", "exchange"):
        assert getattr(ra.query_plan, f) == getattr(rc.query_plan, f)
    for f in ("n", "t", "distinct"):
        assert getattr(ra.query_plan.profile, f) == \
            getattr(rc.query_plan.profile, f)
    for f in ("heavy_keys", "heavy_counts", "countmin"):
        np.testing.assert_array_equal(getattr(ra.query_plan.profile, f),
                                      getattr(rc.query_plan.profile, f))
    assert torch.equal(ka.cpu(), kc)
    s, t = zipf_tables(3000, 2500, theta=0.5, seed=3)
    rows_s, rows_t = np.arange(3000), np.arange(2500)
    planner.clear_plan_cache()
    out, rep = cluster.join(s, rows_s, t, rows_t, algorithm="auto",
                            t_machines=8)
    planner.clear_plan_cache()
    out_c, rep_c = cluster.join(s, rows_s, t, rows_t, algorithm="auto",
                                t_machines=8, device="cpu")
    assert rep.query_plan.algorithm == rep_c.query_plan.algorithm
    assert rep.query_plan.profile.est_join_size == \
        rep_c.query_plan.profile.est_join_size
    for f in out._fields:
        assert torch.equal(getattr(out, f).cpu(), getattr(out_c, f))
    cluster.join(s, rows_s, t, rows_t, algorithm="auto", t_machines=8,
                 device="cpu")
    assert planner.planner_stats()["cache_hits"] == 1
    planner.clear_plan_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_fingerprint_on_the_card_equals_the_cpus(card, dtype):
    """The digest's wrapping int64 sums give the same bits on the card
    as on the CPU, so a plan's key does not depend on where its rows
    lie."""
    x = torch.from_numpy(uniform_keys(64 * 4099, seed=5) * 1e6).to(dtype)
    x[7] = x[8]
    assert planner.plan.fingerprint_arrays(x.to(card), extra="q") == \
        planner.plan.fingerprint_arrays(x, extra="q")


@pytest.mark.cuda
def test_timeit_synchronizes_a_result_on_the_card(card, monkeypatch):
    synced = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d) or sync(d))
    x = np.random.default_rng(7).normal(size=(8, 4096)).astype(np.float32)
    res = obs.timeit(lambda: cluster.sort(x), reps=2, warmup=1)
    assert len(synced) == 3 and res.last_result[0][0].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["capacity", "alpha_k", "cluster", "auto"])
def test_moe_dispatch_on_the_card_equals_the_cpu(card, mode):
    """One MoE layer (d 64, 8 experts, top-2) over t = 8 on the card
    against the CPU on the same weights: the report's counts, capacity,
    attempts and phases equal, y within the reference's 2e-4."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models.moe import init_moe
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, extra_slots=4)
    p = init_moe(torch.Generator().manual_seed(0), 64, cfg, torch.float32,
                 "cpu")
    x = torch.randn((512, 64), generator=torch.Generator().manual_seed(1))
    planner.clear_plan_cache()
    yg, got = cluster.moe_dispatch(p, x, cfg, mode=mode, t_machines=8)
    planner.clear_plan_cache()
    yc, want = cluster.moe_dispatch(p, x, cfg, mode=mode, t_machines=8,
                                    device="cpu")
    assert yg.is_cuda
    torch.testing.assert_close(yg.cpu(), yc, rtol=2e-4, atol=2e-4)
    assert got.algorithm == want.algorithm
    for f in ("slot_workload", "expert_workload", "workload"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("total_dropped", "k_slot", "capacity", "capacity_attempts"):
        assert getattr(got, f, None) == getattr(want, f, None), f
    for a, b in zip(got.phases, want.phases):
        assert a.name == b.name
        np.testing.assert_array_equal(a.sent, b.sent)
        np.testing.assert_array_equal(a.received, b.received)
