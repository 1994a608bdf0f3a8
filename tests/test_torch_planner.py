"""The port's planner against the reference's, on the CPU.

The sketches run on the port's ops (the sorted-runs pass: ``ops.sort``
and two per-row ``ops.searchsorted`` sweeps) and must give the
reference's shard sketches bitwise -- heavy keys and counts, CountMin
table, KMV minima -- so the merged profiles, the cost model's estimates
and the chosen plan are the reference's too.  ``algorithm="auto"``
must equal the call naming the winner, bitwise, and a repeated query
must hit the plan cache and run no sketch.  The reference runs its jnp
backend, as its planner tests do, and its Pallas kernels in interpret
mode where the shard sketches say so.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro import planner as jplanner
from repro.cluster.substrate import VmapSubstrate
from repro.planner import sketch as jsketch
from repro_torch import cluster, planner
from repro_torch.cluster import BatchedSubstrate
from repro_torch.core import MASKED_KEY
from repro_torch.data import scalar_skew_tables, uniform_keys, zipf_tables
from repro_torch.planner import sketch
from repro_torch.planner.plan import fingerprint_arrays, sketch_sort_plan

from test_torch_terasort import assert_reports_equal


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    planner.clear_plan_cache()
    jplanner.clear_plan_cache()
    yield
    planner.clear_plan_cache()
    jplanner.clear_plan_cache()


def assert_sketch_equal(got, want):
    """One shard sketch of the port (tensors) against the reference's."""
    for field in jsketch.ShardSketch._fields:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def as_dicts(costs):
    """CostEstimates (one, or a dict of them) as plain dicts: the two
    packages' dataclasses are distinct classes."""
    if isinstance(costs, dict):
        return {k: dataclasses.asdict(c) for k, c in costs.items()}
    return dataclasses.asdict(costs)


def assert_profile_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        elif dataclasses.is_dataclass(w):
            assert_profile_equal(g, w)
        else:
            assert g == w, f.name


SHARDS = {
    "int_runs": lambda r: r.integers(0, 20, 512).astype(np.int32),
    "int_wide": lambda r: r.integers(-2**31, 2**31 - 1, 256).astype(np.int32),
    "float": lambda r: r.normal(size=256).astype(np.float32),
    "float_dups": lambda r: np.round(r.normal(size=2048), 1).astype(
        np.float32),
    "few": lambda r: np.repeat(np.arange(40, dtype=np.int32), 8),
    "short": lambda r: r.integers(0, 5, 6).astype(np.int32),
}


@pytest.mark.parametrize("sample", [None, 512, 100])
@pytest.mark.parametrize("case", sorted(SHARDS))
def test_shard_sketch_matches_reference(case, sample):
    """Against both reference backends -- but where a run of equal keys
    mixes -0.0 and +0.0 (``float_dups``), the run's representative (and
    so its KMV hash) is the first in sorted order: the reference's
    stable ``jnp.sort`` keeps the zeros in input order, its bitonic
    kernel and the port's do not, so there only the kernel path is the
    port's."""
    keys = SHARDS[case](np.random.default_rng(len(case)))
    got = sketch.shard_sketch(torch.from_numpy(keys), sample=sample)
    backends = ("pallas",) if case == "float_dups" else ("reference",
                                                         "pallas")
    for backend in backends:
        want = jsketch.shard_sketch(jnp.asarray(keys), sample=sample,
                                    kernel_backend=backend)
        assert_sketch_equal(got, want)


def test_masked_join_shards_match_reference():
    keys = np.random.default_rng(3).integers(0, 50, (4, 300)).astype(np.int32)
    keys[:, 250:] = MASKED_KEY
    got = sketch.shard_sketch(torch.from_numpy(keys), masked=MASKED_KEY)
    for i in range(4):
        want = jsketch.shard_sketch(jnp.asarray(keys[i]), masked=MASKED_KEY)
        assert_sketch_equal(jsketch.ShardSketch(*(f[i] for f in got)), want)


def test_misra_gries_branch_past_the_reference_gate():
    """A shard past the reference's 2^16 lanes, unsampled: the reference
    refuses its sorted-runs pass, and the port mirrors it -- Misra-Gries
    and a sort of the hashes -- though its own kernels would take it."""
    keys = np.random.default_rng(4).integers(0, 9, 65537).astype(np.int32)
    keys[::3] = 5
    assert not sketch._reference_sorts(torch.from_numpy(keys))
    got = sketch.shard_sketch(torch.from_numpy(keys))
    want = jsketch.shard_sketch(jnp.asarray(keys))
    assert_sketch_equal(got, want)


@pytest.mark.parametrize("masked", [None, MASKED_KEY])
def test_misra_gries_matches_reference(masked):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 10_000, (3, 600)).astype(np.int32)
    keys[:, :200] = 777
    keys[1, 300:310] = MASKED_KEY
    rng.shuffle(keys, axis=1)
    sk, sc = sketch.misra_gries(torch.from_numpy(keys), 8, masked=masked)
    for i in range(3):
        wk, wc = jsketch.misra_gries(jnp.asarray(keys[i]), 8, masked=masked)
        np.testing.assert_array_equal(sk[i].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(sc[i].numpy(), np.asarray(wc))


def test_hashes_wrap_as_the_reference_uint32():
    """The int64-masked hashes against the reference's uint32 ones, over
    keys whose products wrap, and the host CountMin query against the
    cells the device hash filled."""
    rng = np.random.default_rng(7)
    u = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        [0, 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    ku = torch.from_numpy(u.astype(np.int64))
    np.testing.assert_array_equal(
        sketch._cm_hash(ku, 4, 512).numpy(),
        np.asarray(jsketch._cm_hash(jnp.asarray(u), 4, 512)))
    np.testing.assert_array_equal(sketch._kmv_hash(ku).numpy(),
                                  np.asarray(jsketch._kmv_hash(jnp.asarray(u))))
    for keys in (rng.integers(-2**31, 2**31 - 1, 256).astype(np.int32),
                 rng.normal(size=256).astype(np.float32)):
        cm = sketch.shard_sketch(torch.from_numpy(keys)).countmin.numpy()
        h = sketch._cm_hash(sketch._to_u32(torch.from_numpy(keys)), 3, 512)
        dev = cm[np.arange(3)[:, None], h.numpy()].min(axis=0)
        np.testing.assert_array_equal(sketch.countmin_query(cm, keys), dev)


def test_sketch_table_profile_and_phase_match_reference():
    t, m = 4, 256
    x = np.random.default_rng(4).integers(100, 10_000, (t, m)).astype(
        np.int32)
    x[:, :100] = 7
    prof, tape = sketch.sketch_table(torch.from_numpy(x), BatchedSubstrate(t))
    jprof, jtape = jsketch.sketch_table(jnp.asarray(x), VmapSubstrate(t))
    assert_profile_equal(prof, jprof)
    assert prof.heavy_keys[0] == 7 and int(prof.heavy_counts[0]) == 400
    [p], [q] = tape.phases(t), jtape.phases(t)
    assert p.name == q.name == sketch.SKETCH_PHASE
    np.testing.assert_array_equal(p.sent, q.sent)
    np.testing.assert_array_equal(p.received, q.received)


JOIN_TABLES = {
    "zipf": lambda: zipf_tables(2000, 2000, theta=1.0, seed=5, domain=120),
    "zipf_skew": lambda: zipf_tables(2000, 1500, theta=-0.5, seed=5,
                                     domain=120),
    "hotkey": lambda: scalar_skew_tables(1500, 250, 80, seed=14),
    "broadcast": lambda: (np.arange(100, dtype=np.int32),
                          np.arange(5000, dtype=np.int32)),
}


@pytest.mark.parametrize("t", [4, 6, 8])
@pytest.mark.parametrize("case", sorted(JOIN_TABLES))
def test_join_profiles_costs_and_choice_match_reference(case, t):
    s_keys, t_keys = JOIN_TABLES[case]()
    s32, t32 = np.asarray(s_keys, np.int32), np.asarray(t_keys, np.int32)
    prof, _ = sketch.profile_join_tables(s32, t32, t, BatchedSubstrate(t),
                                         masked=MASKED_KEY, device="cpu")
    jprof, _ = jsketch.profile_join_tables(s32, t32, t, VmapSubstrate(t),
                                           masked=MASKED_KEY)
    assert_profile_equal(prof, jprof)
    for budget in (None, 50):
        costs = planner.join_costs(prof, t, mem_budget=budget)
        jcosts = jplanner.join_costs(jprof, t, mem_budget=budget)
        assert as_dicts(costs) == as_dicts(jcosts)
        assert planner.select(costs).algorithm == \
            jplanner.select(jcosts).algorithm


SORT_INPUTS = {
    "big": (8, 2048, 6), "tiny": (16, 64, 7), "mid": (4, 512, 8),
    "t64": (64, 1024, 9),
}


@pytest.mark.parametrize("case", sorted(SORT_INPUTS))
def test_sort_plan_matches_reference(case):
    """The reference's decision points (t^3 << n: SMMS; t^3 >> n:
    Terasort) and the exchange topology, from the same profile."""
    t, m, seed = SORT_INPUTS[case]
    x = uniform_keys(t * m, seed=seed).reshape(t, m)
    plan, phases = planner.plan_sort_query(x, t=t, device="cpu")
    jplan, jphases = jplanner.plan_sort_query(jnp.asarray(x), t=t)
    assert (plan.algorithm, plan.exchange) == (jplan.algorithm,
                                               jplan.exchange)
    assert as_dicts(plan.predicted) == as_dicts(jplan.predicted)
    assert as_dicts(plan.candidates) == as_dicts(jplan.candidates)
    assert plan.exchange_costs == jplan.exchange_costs
    assert_profile_equal(plan.profile, jplan.profile)
    assert [p.name for p in phases] == [p.name for p in jphases]
    assert plan.algorithm == {"big": "smms", "tiny": "terasort"}.get(
        case, plan.algorithm)


@pytest.mark.parametrize("t,m", [(8, 1024), (256, 512), (6, 1024),
                                 (64, 65536), (4096, 4096)])
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_choose_exchange_matches_reference(algorithm, t, m):
    for chunks in (1, 2, 4):
        got = planner.choose_exchange(t, m, algorithm=algorithm,
                                      overlap_chunks=chunks)
        assert got == jplanner.choose_exchange(t, m, algorithm=algorithm,
                                               overlap_chunks=chunks)
    assert planner.exchange_costs(6, 1024, cap_factor=2.0).keys() == {"flat"}


def test_auto_sort_equals_the_named_winner_and_caches():
    t, m = 8, 512
    x = uniform_keys(t * m, seed=10).reshape(t, m)
    (ka, _), ra = cluster.sort(x, algorithm="auto", exchange="auto",
                               device="cpu")
    (jk, _), jra = jcluster.sort(jnp.asarray(x), algorithm="auto",
                                 exchange="auto")
    plan = ra.query_plan
    assert (plan.algorithm, plan.exchange) == (jra.query_plan.algorithm,
                                               jra.query_plan.exchange)
    assert ra.exchange_topology == plan.exchange
    assert (ra.predicted_alpha, ra.predicted_k, ra.predicted_k_network) == \
        (jra.predicted_alpha, jra.predicted_k, jra.predicted_k_network)
    np.testing.assert_array_equal(ka.numpy(), np.asarray(jk))
    (kf, _), rf = cluster.sort(x, algorithm=plan.algorithm,
                               exchange=plan.exchange, device="cpu")
    assert torch.equal(ka, kf)
    assert_reports_equal(ra, rf)
    assert [p.name for p in ra.sketch_phases] == [sketch.SKETCH_PHASE]
    assert planner.planner_stats()["sketch_runs"] == 1
    (kb, _), rb = cluster.sort(x, algorithm="auto", exchange="auto",
                               device="cpu")
    st = planner.planner_stats()
    assert st["sketch_runs"] == 1 and st["cache_hits"] == 1
    assert rb.query_plan.cached and rb.sketch_phases == []
    assert torch.equal(kb, ka)
    y = uniform_keys(t * m, seed=11).reshape(t, m)
    cluster.sort(y, algorithm="auto", device="cpu")
    assert planner.planner_stats()["sketch_runs"] == 2


@pytest.mark.parametrize("flavor", ["uniform", "lumpy", "duplicates"])
def test_auto_sort_with_values_matches_reference(flavor):
    t, m = 4, 256
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1000, t * m).astype(np.float32)
    if flavor == "lumpy":
        centers = rng.uniform(0, 1000, 8)
        x = (centers[rng.integers(0, 8, t * m)]
             + rng.normal(0, 1.0, t * m)).astype(np.float32)
    elif flavor == "duplicates":
        x[: t * m // 5] = np.float32(500.0)
    x = x.reshape(t, m)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    (ka, va), ra = cluster.sort(x, algorithm="auto", values=v, device="cpu")
    (jk, jv), jra = jcluster.sort(jnp.asarray(x), algorithm="auto", values=v)
    assert ra.query_plan.algorithm == jra.query_plan.algorithm
    assert ra.predicted_k == jra.predicted_k
    np.testing.assert_array_equal(ka.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(va.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ra.workload, jra.workload)
    assert ra.alpha == ra.predicted_alpha


GRID = {
    "uniform": lambda: zipf_tables(1500, 1500, theta=1.0, seed=11,
                                   domain=150),
    "zipf1.5": lambda: zipf_tables(1200, 1200, theta=-0.5, seed=13,
                                   domain=150),
    "hotkey": lambda: scalar_skew_tables(1500, 250, 80, seed=14),
}


@pytest.mark.parametrize("cell", sorted(GRID))
def test_auto_join_picks_the_reference_plan_and_equals_the_winner(cell):
    s_keys, t_keys = GRID[cell]()
    rows_s = np.arange(len(s_keys), dtype=np.int32)
    rows_t = np.arange(len(t_keys), dtype=np.int32)
    t = 8
    out_a, rep_a = cluster.join(s_keys, rows_s, t_keys, rows_t,
                                algorithm="auto", t_machines=t, device="cpu")
    _, jrep = jcluster.join(s_keys, rows_s, t_keys, rows_t,
                            algorithm="auto", t_machines=t)
    plan = rep_a.query_plan
    assert plan.algorithm == jrep.query_plan.algorithm
    assert as_dicts(plan.candidates) == as_dicts(jrep.query_plan.candidates)
    assert_profile_equal(plan.profile, jrep.query_plan.profile)
    assert (rep_a.predicted_alpha, rep_a.predicted_k) == \
        (jrep.predicted_alpha, jrep.predicted_k)
    assert rep_a.alpha == rep_a.predicted_alpha
    out_f, rep_f = cluster.join(s_keys, rows_s, t_keys, rows_t,
                                algorithm=plan.algorithm, t_machines=t,
                                device="cpu")
    for field in ("s_rows", "t_rows", "valid", "count", "dropped"):
        assert torch.equal(getattr(out_a, field), getattr(out_f, field))
    assert (rep_a.k_workload, rep_a.k_network) == (rep_f.k_workload,
                                                   rep_f.k_network)
    if plan.algorithm != "randjoin":        # the reference draws its own
        for field in ("s_rows", "t_rows", "valid", "count", "dropped"):
            want = np.asarray(getattr(_reference_join(
                s_keys, rows_s, t_keys, rows_t, plan.algorithm, t), field))
            np.testing.assert_array_equal(
                getattr(out_a, field).numpy(), want.reshape(
                    getattr(out_a, field).shape))
    assert [p.name for p in rep_a.sketch_phases] == [sketch.SKETCH_PHASE]
    cluster.join(s_keys, rows_s, t_keys, rows_t, algorithm="auto",
                 t_machines=t, device="cpu")
    st = planner.planner_stats()
    assert st["sketch_runs"] == 1 and st["cache_hits"] == 1


def _reference_join(s_keys, rows_s, t_keys, rows_t, algorithm, t):
    out, _ = jcluster.join(s_keys, rows_s, t_keys, rows_t,
                           algorithm=algorithm, t_machines=t)
    return out


def test_auto_join_mem_budget_rules_out_broadcast():
    s_keys = np.arange(100, dtype=np.int32)
    t_keys = np.arange(5000, dtype=np.int32) % 300
    rows_s, rows_t = np.arange(100), np.arange(5000)
    _, rep = cluster.join(s_keys, rows_s, t_keys, rows_t, algorithm="auto",
                          t_machines=4, mem_budget=50, device="cpu")
    _, jrep = jcluster.join(s_keys, rows_s, t_keys, rows_t,
                            algorithm="auto", t_machines=4, mem_budget=50)
    assert not rep.query_plan.candidates["broadcast"].feasible
    assert rep.query_plan.algorithm == jrep.query_plan.algorithm \
        != "broadcast"


def test_sort_cost_ordering_invariant_under_shard_permutation():
    t, m = 8, 256
    rng = np.random.default_rng(15)
    x = rng.uniform(0.0, 1000.0, (t, m)).astype(np.float32)
    x[:, :50] = np.float32(500.0)
    xp = np.stack([row[rng.permutation(m)] for row in x])
    sub = BatchedSubstrate(t)
    prof, _ = sketch.profile_sorted_shards(torch.from_numpy(x), sub)
    prof_p, _ = sketch.profile_sorted_shards(torch.from_numpy(xp), sub)
    assert as_dicts(planner.sort_costs(prof, t)) == \
        as_dicts(planner.sort_costs(prof_p, t))


def test_fingerprint_reads_the_host_array_and_counts_device_copies():
    """A host array is hashed as the tensor of its bytes; no copy of the
    rows is made or counted."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert fingerprint_arrays(x) == fingerprint_arrays(torch.from_numpy(x))
    assert fingerprint_arrays(x) != fingerprint_arrays(x + 1)
    assert "fingerprint_device_copies" not in planner.planner_stats()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("at", [0, 1, 4095, 4096, -1])
def test_fingerprint_sees_every_word(dtype, at):
    """A change of any one element, at either end or mid-row, and in a
    dtype whose bytes do not fill the last 32-bit word, changes the key;
    so do the shape, the dtype and the query string."""
    x = torch.from_numpy(np.random.default_rng(9).integers(
        0, 100, 8191).astype(np.float32)).to(getattr(torch, dtype))
    key = fingerprint_arrays(x, extra="q")
    assert key == fingerprint_arrays(x.clone(), extra="q")
    y = x.clone()
    y[at] += 1
    assert fingerprint_arrays(y, extra="q") != key
    assert fingerprint_arrays(x[:-1].reshape(-1, 1), extra="q") != (
        fingerprint_arrays(x[:-1], extra="q"))
    assert fingerprint_arrays(x.view(torch.uint8)[:4], extra="q") != (
        fingerprint_arrays(x.view(torch.int8)[:4], extra="q"))
    assert fingerprint_arrays(x, extra="r") != key


def test_tensor_digest_wraps_as_uint64_sums():
    """The digest's sums wrap mod 2^64 as the host's exact integers do."""
    from repro_torch.planner import plan
    x = np.random.default_rng(11).integers(0, 1 << 32, 1000,
                                           dtype=np.uint64)
    words = torch.from_numpy(x.astype(np.uint32).view(np.int32))
    want = []
    for lane in range(plan.FINGERPRINT_LANES):
        w = plan._weights(len(x), lane, "cpu").numpy().view(np.uint64)
        z = (np.arange(len(x), dtype=object) + (lane + 1) * plan._GOLDEN)
        z = [int(v) % (1 << 64) for v in z]
        exact = []
        for v in z:
            v = ((v ^ (v >> 30)) * plan._MIX1) % (1 << 64)
            v = ((v ^ (v >> 27)) * plan._MIX2) % (1 << 64)
            exact.append((v ^ (v >> 31)) | 1)
        assert w.tolist() == exact
        want.append(sum(a * int(b) for a, b in zip(exact, x)) % (1 << 64))
    assert plan.tensor_digest(words) == np.array(
        want, dtype=np.uint64).tobytes()


def test_sketch_sort_plan_is_the_uncached_plan():
    t, m = 8, 256
    x = np.random.default_rng(10).random((t, m)).astype(np.float32)
    planner.clear_plan_cache()
    plan, phases = planner.plan_sort_query(x, t=t, device="cpu")
    direct, direct_phases = sketch_sort_plan(torch.from_numpy(x), t=t)
    assert (direct.algorithm, direct.exchange) == (plan.algorithm,
                                                   plan.exchange)
    assert dataclasses.asdict(direct.predicted) == dataclasses.asdict(
        plan.predicted)
    assert [(p.name, p.sent.tolist(), p.received.tolist())
            for p in direct_phases] == [
        (p.name, p.sent.tolist(), p.received.tolist()) for p in phases]
    assert planner.planner_stats()["sketch_runs"] == 2
    planner.clear_plan_cache()


def test_moe_planner_matches_reference():
    """``plan_moe_query`` on routing ids with a hot expert: the plan,
    its candidates and the sketch round equal the reference's, and the
    hot expert prices plain capacity dispatch as infeasible."""
    import jax
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models.moe import init_moe
    d, e = 16, 4
    p = init_moe(jax.random.key(2), d, JMoEConfig(num_experts=e, top_k=1,
                                                   d_ff_expert=8),
                 jnp.float32)
    router = np.array(p["router"]) * 0.01
    router[:, 0] += np.linspace(0.3, 0.8, d)
    x = np.random.default_rng(4).standard_normal((256, d)).astype(np.float32)
    kw = dict(t_machines=4, num_experts=e, top_k=1, extra_slots=2)
    want, want_phases = jplanner.plan_moe_query(x, jnp.asarray(router), **kw)
    got, got_phases = planner.plan_moe_query(x, router, device="cpu",
                                             **kw)
    assert (got.kind, got.algorithm) == ("moe", want.algorithm)
    assert {n: dataclasses.asdict(c) for n, c in got.candidates.items()} == {
        n: dataclasses.asdict(c) for n, c in want.candidates.items()}
    assert not got.candidates["capacity"].feasible
    assert [(ph.name, ph.sent.tolist(), ph.received.tolist())
            for ph in got_phases] == [
        (ph.name, ph.sent.tolist(), ph.received.tolist())
        for ph in want_phases]
