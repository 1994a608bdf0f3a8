"""The port's cluster-routed MoE dispatch against the reference, on the CPU.

Same numpy-seeded tokens and the reference's ``init_moe`` weights (a hot
expert 0 as ``tests/test_moe_cluster.py:_setup`` biases it, or not)
through both packages:

* ``exchange_routed_rows`` / ``return_routed_rows`` bitwise: the landed
  tiles, ``perm``, ``starts``, ``lens``, ``local_drop``, the round trip
  and every taped phase, with and without pair overflow;
* ``cluster_moe_dispatch`` and ``cluster.moe_dispatch`` in all four
  modes (and a forced retry): every report field and phase bitwise,
  the slot and expert counts, the slot plan, the capacity and its
  attempts; y within the reference's bound, rtol = atol = 2e-4;
* the planner's MoE pieces: ``expert_counts_estimate``,
  ``moe_dispatch_costs``, ``select_dispatch`` and ``plan_moe_query``'s
  plan and sketch phases.

The reference runs as its own MoE tests run it on the CPU (its default
kernel backend, the substrate ``cluster.moe_dispatch`` picks there).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro import planner as jplanner
from repro.cluster.capacity import CapacityPolicy as JCapacityPolicy
from repro.cluster.substrate import VmapSubstrate
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import exchange as jexchange
from repro.core.moe_dispatch import cluster_moe_dispatch as jcluster_moe
from repro.models.moe import init_moe
from repro_torch import cluster, planner
from repro_torch.cluster import BatchedSubstrate, CapacityPolicy
from repro_torch.configs.base import MoEConfig
from repro_torch.core import exchange
from repro_torch.core.alpha_k import report_fields
from repro_torch.core.moe_dispatch import cluster_moe_dispatch

TOL = dict(rtol=2e-4, atol=2e-4)
REPORT_ARRAYS = ("slot_workload", "expert_workload")
REPORT_SCALARS = ("dispatch_mode", "k_slot", "k_expert", "total_dropped")
CLUSTER_FIELDS = ("capacity", "slot2expert", "slot_replicas")


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    planner.clear_plan_cache()
    jplanner.clear_plan_cache()
    yield
    planner.clear_plan_cache()
    jplanner.clear_plan_cache()


def setup(d=32, e=8, k=2, tokens=256, hot=True, seed=0, **cfg_kw):
    kw = dict(num_experts=e, top_k=k, d_ff_expert=32, extra_slots=8,
              **cfg_kw)
    p = init_moe(jax.random.key(seed), d, JMoEConfig(**kw), jnp.float32)
    if hot:
        router = np.array(p["router"]) * 0.01
        router[:, 0] += np.linspace(0.3, 0.8, d)
        p["router"] = jnp.asarray(router)
    x = np.random.default_rng(seed + 5).standard_normal(
        (tokens, d)).astype(np.float32)
    host = {name: np.array(w) for name, w in p.items()}
    return p, host, x, JMoEConfig(**kw), MoEConfig(**kw)


def assert_same_reports(got, want):
    g, w = report_fields(got), report_fields(want)
    for key in ("algorithm", "n_in", "n_out", "alpha", "k_workload",
                "k_network", "cap_factor", "capacity_attempts"):
        assert g[key] == w[key], key
    np.testing.assert_array_equal(g["workload"], w["workload"])
    assert [p[0] for p in g["phases"]] == [p[0] for p in w["phases"]]
    for (_, gs, gr), (_, ws, wr) in zip(g["phases"], w["phases"]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)
    for key in REPORT_ARRAYS:
        np.testing.assert_array_equal(getattr(got, key),
                                      np.asarray(getattr(want, key)))
    for key in REPORT_SCALARS:
        assert getattr(got, key) == getattr(want, key), key
    if want.dispatch_mode == "cluster":
        for key in CLUSTER_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, key)),
                                          np.asarray(getattr(want, key)))


def assert_same_plans(got, want):
    assert (got.kind, got.algorithm, got.t, got.cached) == (
        want.kind, want.algorithm, want.t, want.cached)
    assert set(got.candidates) == set(want.candidates)
    for name in want.candidates:
        assert dataclasses.asdict(got.candidates[name]) == \
            dataclasses.asdict(want.candidates[name]), name
    for f in ("n", "t", "distinct"):
        assert getattr(got.profile, f) == getattr(want.profile, f), f
    for f in ("heavy_keys", "heavy_counts", "countmin"):
        np.testing.assert_array_equal(getattr(got.profile, f),
                                      np.asarray(getattr(want.profile, f)))


def phases_of(phases):
    return [(p.name, p.sent.tolist(), p.received.tolist()) for p in phases]


# ---------------------------------------------------------------------------
# the routed exchange
# ---------------------------------------------------------------------------

ROUTED = ("recv_keys", "recv_payload", "perm", "dest_sorted", "starts",
          "lens", "local_drop")


def _routed_reference(owner, payload, t, cap_pair):
    sub = VmapSubstrate(t)

    def body(o, pay, *, tape):
        routed = jexchange.exchange_routed_rows(
            o, pay, axis_name=sub.axis_name, t=t, cap_pair=cap_pair,
            tape=tape)
        valid = routed.recv_keys < jexchange.PAD
        back = jnp.where(valid[..., None], routed.recv_payload * 2.0 + 1.0,
                         0.0)
        me = jax.lax.axis_index(sub.axis_name)
        per_src = jnp.sum(valid, axis=1)
        home = jexchange.return_routed_rows(
            back, routed, axis_name=sub.axis_name, tape=tape,
            sent=jnp.sum(per_src) - per_src[me],
            received=jnp.sum(jnp.minimum(routed.lens, cap_pair)))
        return {name: getattr(routed, name) for name in ROUTED}, home

    (routed, home), tape = sub.run(body, jnp.asarray(owner),
                                   jnp.asarray(payload))
    return routed, home, tape.phases(t)


@pytest.mark.parametrize("t, n, cap_pair, skew", [
    (4, 64, 24, False), (4, 64, 10, False), (8, 40, 8, True),
    (2, 33, 40, True)])
def test_routed_rows_match_reference(t, n, cap_pair, skew):
    rng = np.random.default_rng(t * n + cap_pair)
    owner = rng.integers(0, t, (t, n)).astype(np.int32)
    if skew:                              # most rows to machine 0
        owner[:, : n // 2] = 0
    payload = rng.standard_normal((t, n, 5)).astype(np.float32)
    want, want_home, want_phases = _routed_reference(owner, payload, t,
                                                     cap_pair)
    tape = cluster.CollectiveTape()
    got = exchange.exchange_routed_rows(
        torch.from_numpy(owner), torch.from_numpy(payload), t=t,
        cap_pair=cap_pair, tape=tape)
    for name in ROUTED:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want[name]), name)
    valid = got.recv_keys < exchange.PAD
    back = torch.where(valid[..., None], got.recv_payload * 2.0 + 1.0, 0.0)
    per_src = valid.sum(dim=2)
    me = torch.arange(t)
    home = exchange.return_routed_rows(
        back, got, tape=tape, sent=per_src.sum(dim=1) - per_src[me, me],
        received=got.lens.clamp(max=cap_pair).sum(dim=1))
    np.testing.assert_array_equal(home.numpy(), np.asarray(want_home))
    assert phases_of(tape.phases(t)) == phases_of(want_phases)
    # every row that fit its pair tile comes home processed, the rest 0
    lost = int(got.local_drop.sum())
    pair_max = max(np.bincount(row, minlength=t).max() for row in owner)
    assert (lost > 0) == (cap_pair < pair_max)
    np.testing.assert_array_equal(
        (home.numpy() != 0).all(axis=2).sum(), t * n - lost)


# ---------------------------------------------------------------------------
# the cluster dispatch and the front door
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hot, t, k, retry", [
    (True, 4, 2, False), (False, 4, 2, False), (True, 8, 1, False),
    (True, 4, 2, True), (False, 8, 2, True)])
def test_cluster_moe_dispatch_matches_reference(hot, t, k, retry):
    p, host, x, jcfg, cfg = setup(hot=hot, k=k)
    jpolicy = policy = None
    if retry:   # an undersized first tile: the shared retry regrows it
        kw = dict(base_factor=0.25, slack=1.0, growth=2.0, max_retries=4)
        jpolicy, policy = JCapacityPolicy(**kw), CapacityPolicy(**kw)
    want_y, want = jcluster_moe(p, jnp.asarray(x), jcfg, t_machines=t,
                                policy=jpolicy)
    y, got = cluster_moe_dispatch(
        {n: torch.from_numpy(w) for n, w in host.items()},
        torch.from_numpy(x), cfg, t_machines=t, policy=policy,
        substrate=BatchedSubstrate(t))
    assert_same_reports(got, want)
    if retry:
        assert got.capacity_attempts > 1
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)


MODES = ("capacity", "alpha_k", "cluster", "auto")


@pytest.mark.parametrize("hot", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_moe_dispatch_matches_reference(mode, hot):
    p, host, x, jcfg, cfg = setup(hot=hot, tokens=512)
    want_y, want = jcluster.moe_dispatch(p, jnp.asarray(x), jcfg, mode=mode,
                                         t_machines=4)
    y, got = cluster.moe_dispatch(host, x, cfg, mode=mode, t_machines=4,
                                  device="cpu")
    assert_same_reports(got, want)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert hasattr(got, "query_plan") == hasattr(want, "query_plan")
    if mode in ("cluster", "auto"):
        assert_same_plans(got.query_plan, want.query_plan)
        assert phases_of(got.sketch_phases) == phases_of(want.sketch_phases)
        assert got.predicted_alpha == want.predicted_alpha
        assert got.predicted_k == want.predicted_k


def test_moe_dispatch_random_replicas_take_the_reference_draws():
    p, host, x, jcfg, cfg = setup(tokens=256, replica_choice="random")
    key = jax.random.key(4)
    want_y, want = jcluster.moe_dispatch(p, jnp.asarray(x), jcfg,
                                         mode="alpha_k", rng=key)
    draws = np.array(jax.random.randint(key, (1, 256 * cfg.top_k), 0,
                                        1 << 30))
    y, got = cluster.moe_dispatch(host, x, cfg, mode="alpha_k",
                                  draws=torch.from_numpy(draws),
                                  device="cpu")
    assert_same_reports(got, want)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)


def test_plan_cache_short_circuits_the_sketch():
    _, host, x, _, cfg = setup()
    _, first = cluster.moe_dispatch(host, x, cfg, mode="auto", t_machines=4,
                                    device="cpu")
    _, again = cluster.moe_dispatch(host, x, cfg, mode="auto", t_machines=4,
                                    device="cpu")
    assert not first.query_plan.cached and first.sketch_phases
    assert again.query_plan.cached and again.sketch_phases == []
    stats = planner.planner_stats()
    assert stats["cache_hits"] == 1 and stats["sketch_runs"] == 1


def test_expert_workload_is_a_recount_of_the_routing():
    """The taped counts against the routing ids recounted on the host,
    and the slot counts regrouped to their experts."""
    _, host, x, _, cfg = setup(tokens=512)
    _, rep = cluster.moe_dispatch(host, x, cfg, mode="cluster",
                                  t_machines=8, device="cpu")
    ids = planner.plan.routing_ids(torch.from_numpy(x),
                                   torch.from_numpy(host["router"]), t=8,
                                   top_k=cfg.top_k)
    recount = np.bincount(ids.numpy().reshape(-1), minlength=8)
    np.testing.assert_array_equal(rep.expert_workload, recount)
    regroup = np.bincount(rep.slot2expert, weights=rep.slot_workload,
                          minlength=8).astype(np.int64)
    np.testing.assert_array_equal(regroup, recount)
    assert rep.alpha == 3 and int(rep.slot_workload.sum()) == 512 * 2


def test_mode_validation_and_the_card_default(monkeypatch):
    _, host, x, _, cfg = setup(tokens=64)
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        cluster.moe_dispatch(host, x, cfg, mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        cluster.moe_dispatch(host, x, cfg, mode="cluster", t_machines=7,
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.moe_dispatch(host, x, cfg, mode="alpha_k")


# ---------------------------------------------------------------------------
# the planner's MoE pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hot", [True, False])
def test_plan_moe_query_matches_reference(hot):
    p, host, x, jcfg, cfg = setup(hot=hot, tokens=1024, k=2)
    kw = dict(t_machines=8, num_experts=8, top_k=2, extra_slots=8)
    want, want_phases = jplanner.plan_moe_query(x, p["router"], **kw)
    got, got_phases = planner.plan_moe_query(x, host["router"],
                                             device="cpu", **kw)
    assert_same_plans(got, want)
    assert phases_of(got_phases) == phases_of(want_phases)
    counts = planner.expert_counts_estimate(got.profile, 8)
    np.testing.assert_array_equal(
        counts, jplanner.expert_counts_estimate(want.profile, 8))
    again, phases = planner.plan_moe_query(x, host["router"], device="cpu",
                                           **kw)
    assert again.cached and phases == []


@pytest.mark.parametrize("counts, kw", [
    ([900, 40, 30, 30], dict(tokens=500, top_k=2, extra_slots=4)),
    ([100, 100, 100, 100], dict(tokens=200, top_k=2, extra_slots=2)),
    ([1e9] * 4, dict(tokens=64, top_k=1, extra_slots=2)),
    ([3000, 10, 0, 0, 5, 5], dict(tokens=1510, top_k=2, extra_slots=6,
                                  capacity_factor=2.0)),
])
def test_dispatch_costs_match_reference(counts, kw):
    args = dict(num_experts=len(counts), t_machines=2, **kw)
    want = jplanner.moe_dispatch_costs(np.asarray(counts), **args)
    got = planner.moe_dispatch_costs(np.asarray(counts), **args)
    assert {n: dataclasses.asdict(c) for n, c in got.items()} == {
        n: dataclasses.asdict(c) for n, c in want.items()}
    assert planner.select_dispatch(got).algorithm == \
        jplanner.select_dispatch(want).algorithm
    if counts[0] == 1e9:        # every mode drops: alpha_k's retry wins
        assert not any(c.feasible for c in got.values())
        assert planner.select_dispatch(got).algorithm == "alpha_k"
