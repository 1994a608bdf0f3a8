"""The port's query engine against the reference's, on the CPU.

The reference's own trace (``tests/test_serve.py:make_trace``, plus a
repartition join) goes through the port's ``QueryEngine`` on the CPU:
every result equals the reference's ``run_spec`` on the same operands,
bitwise (values; k_workload, k_network, alpha), where the algorithm is
deterministic -- SMMS, StatJoin, broadcast, repartition, and ``auto``
where the planner picks one of them -- and the port's own one-shot call
with the same seed where it draws random numbers (Terasort, RandJoin;
the planner's choice still the reference's).  Then the engine's own
contracts: concurrent submitters, coalescing and the result cache,
backpressure, a malformed spec and a failed query, a pool shared across
engines, ``ServeStats``' shape, the clone rule (a requester's in-place
edit reaches no one else) and a digest that collides (each spec still
gets its own result).  Every wait is bounded.
"""
import threading

import numpy as np
import pytest
import torch

from repro.serve import join_query as jjoin_query
from repro.serve.query import run_spec as jrun_spec
from repro_torch import cluster, obs, planner
from repro_torch.cluster import SubstratePool, reset_default_pool
from repro_torch.data import uniform_keys
from repro_torch.serve import (AdmissionError, EngineClosedError, QueryEngine,
                               QuerySpec, run_spec, sort_query)
from repro_torch.serve import query as serve_query
from repro_torch.serve.query import SERVE_COUNTERS, reset_serve_counters

from test_serve import make_trace

T = 4
WAIT = 120.0          # seconds any one result may take on the CPU
RANDOM = ("terasort", "randjoin")


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's process-wide caches and counters, around each test."""
    def reset():
        planner.clear_plan_cache()
        reset_serve_counters()
        reset_default_pool()
        obs.reset_registry()
        obs.set_tracer(obs.Tracer(enabled=False))
    reset()
    yield
    reset()


def port_spec(spec) -> QuerySpec:
    """The reference's spec with its operands as numpy arrays."""
    return QuerySpec(kind=spec.kind,
                     arrays=tuple(np.array(a) for a in spec.arrays),
                     params=spec.params, tag=spec.tag,
                     priority=spec.priority, deadline_s=spec.deadline_s)


def reference_trace():
    """``make_trace`` at t = 4 and a repartition join of its tables."""
    trace = make_trace(T, np.random.default_rng(20260730))
    sk, rows, tk, _ = trace[4].arrays
    return trace + [jjoin_query(sk, rows, tk, rows, t_machines=T,
                                algorithm="repartition")]


@pytest.fixture(scope="module")
def traces():
    """(reference specs, their reference results, the port's specs)."""
    ref = reference_trace()
    return ref, [jrun_spec(s) for s in ref], [port_spec(s) for s in ref]


def as_numpy(value):
    """A result value's arrays, machine-major (RandJoin's (a, b, ...)
    reference output flattened to (t, ...))."""
    out = []
    for v in value:
        if v is None:
            out.append(None)
            continue
        a = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out.append(a)
    return out


def as_bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def assert_same_value(got, want, ctx=""):
    g, w = as_numpy(got), as_numpy(want)
    assert len(g) == len(w), ctx
    for x, y in zip(g, w):
        if x is None or y is None:
            assert x is None and y is None, ctx
        else:
            y = y.reshape(x.shape) if y.size == x.size else y
            assert x.dtype == y.dtype, ctx
            np.testing.assert_array_equal(as_bytes(x), as_bytes(y),
                                          err_msg=ctx)


def one_shot(spec):
    return run_spec(spec, device="cpu")


def test_engine_results_are_the_references_on_its_trace(traces):
    ref, ref_results, specs = traces
    with QueryEngine(device="cpu", max_batch=4) as eng:
        results = eng.run(specs, timeout=WAIT)
    checked = set()
    for i, (r, (w_val, w_rep)) in enumerate(zip(results, ref_results)):
        assert r.ok, (i, r.error)
        algorithm = dict(specs[i].params)["algorithm"]
        chosen = r.report.query_plan.algorithm if algorithm == "auto" \
            else algorithm
        if algorithm == "auto":
            assert chosen == w_rep.query_plan.algorithm, i
        if chosen in RANDOM:
            w_val, w_rep = one_shot(specs[i])
        else:
            checked.add(algorithm)
        assert_same_value(r.value, w_val, ctx=f"query {i} ({algorithm})")
        assert r.report.k_workload == w_rep.k_workload, i
        assert r.report.k_network == w_rep.k_network, i
        assert r.report.alpha == w_rep.alpha, i
        assert (getattr(r.report, "capacity_attempts", None)
                == getattr(w_rep, "capacity_attempts", None)), i
    assert checked == {"smms", "auto", "statjoin", "broadcast",
                       "repartition"}


def test_concurrent_submitters_match_one_shot_calls(traces):
    _, _, trace = traces
    want = [one_shot(s) for s in trace]
    unique_auto = {s.fingerprint(device="cpu") for s in trace
                   if dict(s.params).get("algorithm") == "auto"}
    collected, errors = {}, []
    with QueryEngine(device="cpu", max_batch=4, workers=2,
                     batch_window_s=0.01) as eng:
        def submitter(indices):
            try:
                tickets = [(i, eng.submit(trace[i])) for i in indices]
                for i, tk in tickets:
                    collected[i] = tk.result(timeout=WAIT)
            except Exception as exc:  # pragma: no cover - surfaced below
                errors.append(exc)

        n_threads = 5
        threads = [threading.Thread(target=submitter,
                                    args=(range(k, len(trace), n_threads),))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
            assert not th.is_alive(), "a submitter never finished"
        stats = eng.stats()
    assert not errors
    assert len(collected) == len(trace)
    for i, (w_val, w_rep) in enumerate(want):
        r = collected[i]
        assert r.ok, (i, r.error)
        assert_same_value(r.value, w_val, ctx=f"query {i}")
        assert r.report.k_workload == w_rep.k_workload, i
    # the one-shot pass filled the plan cache: the engine never sketched
    st = planner.planner_stats()
    assert st.get("sketch_runs", 0) == len(unique_auto)
    assert st.get("cache_misses", 0) == len(unique_auto)
    assert stats.served == len(trace) and stats.failed == 0
    assert (stats.executed + stats.coalesced
            + stats.result_cache_hits) == len(trace)
    assert SERVE_COUNTERS["submitted"] == len(trace)
    assert SERVE_COUNTERS["served"] == len(trace)
    assert SERVE_COUNTERS["admitted"] == len(trace)


def small(seed, m=128, **kw):
    x = uniform_keys(T * m, seed=seed).reshape(T, m)
    return sort_query(x, algorithm=kw.pop("algorithm", "smms"), **kw)


def test_coalescing_serves_identical_queries_once():
    spec = small(7)
    with QueryEngine(device="cpu", max_batch=8, batch_window_s=0.05) as eng:
        results = eng.run([spec] * 6, timeout=WAIT)
        stats = eng.stats()
    assert all(r.ok for r in results)
    for r in results[1:]:
        assert_same_value(r.value, results[0].value)
    assert stats.executed < 6
    assert stats.executed + stats.coalesced + stats.result_cache_hits == 6
    assert len({id(r.report) for r in results}) == 6
    assert len({id(r.value[0]) for r in results}) == 6
    results[0].report.poison = "x"
    assert not any(hasattr(r.report, "poison") for r in results[1:])


def test_result_cache_across_batches():
    spec = small(21)
    with QueryEngine(device="cpu") as eng:
        [first] = eng.run([spec], timeout=WAIT)
        first.report.poison = "x"
        [second] = eng.run([spec], timeout=WAIT)
        stats = eng.stats()
        assert len(eng.results) == 1
        held = eng.results.nbytes()
    assert first.ok and second.ok
    assert not first.cached and second.cached
    assert stats.executed == 1 and stats.result_cache_hits == 1
    assert_same_value(second.value, first.value)
    assert not hasattr(second.report, "poison")
    assert second.report.k_workload == first.report.k_workload
    # the entry holds its operands (the keys) and its value (the keys
    # sorted), on the engine's device
    assert held == {"cpu": 2 * T * 128 * 4}

    with QueryEngine(device="cpu", result_cache_size=0) as eng:
        [a] = eng.run([spec], timeout=WAIT)
        [b] = eng.run([spec], timeout=WAIT)
        stats = eng.stats()
    assert stats.executed == 2 and stats.result_cache_hits == 0
    assert not b.cached
    assert_same_value(a.value, b.value)


def test_clone_rule_no_edit_reaches_another_requester():
    """Twins, cache hits and the cache's own entry each hold their own
    tensors; editing the caller's input after the run does not reach
    the cache either (the engine ran on its own copy)."""
    x = uniform_keys(T * 128, seed=5).reshape(T, 128)
    v = np.arange(T * 128 * 2, dtype=np.int32).reshape(T, 128, 2)
    spec = sort_query(x, algorithm="smms", values=v)
    want, _ = one_shot(spec)
    with QueryEngine(device="cpu", max_batch=8, batch_window_s=0.05) as eng:
        twins = eng.run([spec] * 3, timeout=WAIT)
        for r in twins:
            assert r.ok
        twins[0].value[0].zero_()
        twins[0].value[1].fill_(-1)
        for r in twins[1:]:
            assert_same_value(r.value, want)
        [hit] = eng.run([spec], timeout=WAIT)
        assert hit.cached
        assert_same_value(hit.value, want)
        hit.value[0].add_(1.0)
        [hit2] = eng.run([spec], timeout=WAIT)
        assert hit2.cached
        assert_same_value(hit2.value, want)
        # the caller edits its input in place: the cached operands are
        # the engine's copy, so the edited query runs anew
        x[0, 0] = np.float32(-1.0)
        [fresh] = eng.run([spec], timeout=WAIT)
        assert not fresh.cached and not fresh.coalesced
        assert_same_value(fresh.value, one_shot(spec)[0])


def test_colliding_digest_still_gives_each_spec_its_result(monkeypatch):
    """With every spec keyed alike, in flight and in the cache, the
    byte comparison keeps two different specs apart."""
    monkeypatch.setattr(serve_query, "fingerprint_arrays",
                        lambda *a, **k: "same-key")
    a, b = small(31), small(32)
    want_a, want_b = one_shot(a)[0], one_shot(b)[0]
    with QueryEngine(device="cpu", max_batch=8, batch_window_s=0.05) as eng:
        ra, rb, ra2 = eng.run([a, b, a], timeout=WAIT)
        [rb2] = eng.run([b], timeout=WAIT)
        [ra3] = eng.run([a], timeout=WAIT)
        stats = eng.stats()
    for r, want in ((ra, want_a), (rb, want_b), (ra2, want_a),
                    (rb2, want_b), (ra3, want_a)):
        assert r.ok
        assert_same_value(r.value, want)
    assert not rb.coalesced and not rb.cached
    assert stats.executed + stats.coalesced + stats.result_cache_hits == 5
    assert stats.executed >= 2


def test_backpressure_rejects_and_recovers():
    x = uniform_keys(T * 64, seed=9).reshape(T, 64)
    eng = QueryEngine(device="cpu", max_pending=3, autostart=False)
    tickets = [eng.submit(sort_query(x, algorithm="smms", tag=str(i)))
               for i in range(3)]
    with pytest.raises(AdmissionError):
        eng.submit(sort_query(x, algorithm="smms", tag="overflow"),
                   block=False)
    eng.start()
    results = [tk.result(timeout=WAIT) for tk in tickets]
    eng.close()
    assert all(r.ok for r in results)
    assert eng.stats().rejected == 1
    assert SERVE_COUNTERS["rejected"] == 1
    with pytest.raises(EngineClosedError):
        eng.submit(sort_query(x))


def test_malformed_spec_cannot_kill_the_dispatcher():
    bad = sort_query([[1.0, 2.0, 3.0], [4.0, 5.0]], algorithm="smms")
    good = small(17, m=64)
    with QueryEngine(device="cpu") as eng:
        r_bad, r_good = eng.run([bad, good], timeout=WAIT)
    assert not r_bad.ok and r_bad.error
    assert r_good.ok


def test_failed_query_is_isolated():
    good = small(11, m=64)
    bad = small(12, m=64, algorithm="quicksort")
    with QueryEngine(device="cpu") as eng:
        r_good, r_bad, r_good2 = eng.run([good, bad, good], timeout=WAIT)
        stats = eng.stats()
    assert r_good.ok and r_good2.ok
    assert not r_bad.ok and "quicksort" in r_bad.error
    assert r_bad.report is None
    assert stats.failed == 1 and stats.served == 2


def test_shared_pool_serves_both_engines():
    """Two engines on one pool run on the same substrates; the port
    compiles nothing, so each engine's stats show 0 compiles, and its
    substrate runs a query (the pool's counters, per engine)."""
    x = uniform_keys(T * 128, seed=13).reshape(T, 128)
    pool = SubstratePool()
    trace = [sort_query(x, algorithm="smms"),
             sort_query(x, algorithm="terasort", seed=1)]
    with QueryEngine(device="cpu", pool=pool) as eng:
        assert all(r.ok for r in eng.run(trace, timeout=WAIT))
        first = eng.stats()
    subs = pool.substrates()
    assert [s.axes for s in subs] == [(("i", T),)]
    with QueryEngine(device="cpu", pool=pool) as eng2:
        assert all(r.ok for r in eng2.run(trace, timeout=WAIT))
        second = eng2.stats()
    assert pool.substrates() == subs
    assert first.compiles == second.compiles == 0
    assert first.program_counts == second.program_counts == {}
    assert first.programs_per_query == second.programs_per_query == 1.0
    assert pool.stats()["runs"] == 4
    assert pool.stats()["runs[smms_shard]"] == 2


def test_front_door_runs_on_the_given_pool():
    """``substrate=`` reaches every run: the sorts and 1D joins ask for
    ``(t,)``, staged sorts for the two staged axes, RandJoin for the
    reference's ``(("a", a), ("b", b))``, and ``auto``'s sketch for
    ``(t,)``; a provider that returns something else is refused."""
    x = uniform_keys(8 * 64, seed=3).reshape(8, 64)
    keys = np.arange(64, dtype=np.int32) % 7
    rows = np.arange(64, dtype=np.int32)
    pool = SubstratePool()
    cluster.sort(x, substrate=pool, device="cpu")
    cluster.sort(x, algorithm="auto", substrate=pool, device="cpu")
    cluster.sort(x, exchange="staged", substrate=pool, device="cpu")
    cluster.join(keys, rows, keys, rows, algorithm="randjoin", t_machines=8,
                 ab=(2, 4), substrate=pool, device="cpu")
    for algorithm in ("statjoin", "broadcast", "repartition"):
        cluster.join(keys, rows, keys, rows, algorithm=algorithm,
                     t_machines=8, substrate=pool, device="cpu")
    axes = {s.axes: s.stats_snapshot() for s in pool.substrates()}
    assert set(axes) == {(("i", 8),), (("i1", 4), ("i2", 2)),
                         (("a", 2), ("b", 4))}
    assert axes[(("i", 8),)]["runs"] == 6          # 2 sorts, sketch, joins
    assert axes[(("i", 8),)]["runs[sketch_body]"] == 1
    assert axes[(("i1", 4), ("i2", 2))]["runs[smms_shard]"] == 1
    assert axes[(("a", 2), ("b", 4))]["runs[randjoin_shard]"] == 1
    with pytest.raises(TypeError, match="BatchedSubstrate"):
        cluster.sort(x, substrate=lambda *axes: object(), device="cpu")


def test_serve_stats_shape():
    spec = small(15, algorithm="auto")
    with QueryEngine(device="cpu") as eng:
        eng.run([spec, spec], timeout=WAIT)
        stats = eng.stats()
    s = stats.summary()
    assert s["served"] == 2 and s["qps"] > 0
    assert 0 <= s["p50_latency_s"] <= s["p99_latency_s"]
    assert stats.sketch_runs == 1
    assert 0.0 <= s["plan_cache_hit_rate"] <= 1.0
    assert set(s) == {f.name for f in
                      __import__("dataclasses").fields(type(stats))}
    assert s["latency_by_class"]["normal"]["p50"] > 0


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        small(1).fingerprint()


def test_counts_survive_many_threads():
    """The counters the engine's workers share -- ``cuda.LAUNCHES`` (a
    launch's count, under its lock) and a substrate's run counts --
    lose no update with more threads than cores and a short switch
    interval.  The launch goes through ``cuda.launch`` with its C entry
    stood in by a function that returns 0 (no card here)."""
    import sys

    from repro_torch.cluster import BatchedSubstrate
    from repro_torch.kernels import cuda

    threads, per_thread = 16, 400
    sub = BatchedSubstrate(2)
    x = torch.zeros(2, 1)
    entry = "stress_probe_f32"
    saved = (cuda._device, cuda._raw_stream)
    cuda._ENTRIES[entry] = lambda *args: 0
    cuda._device, cuda._raw_stream = (lambda: 0), (lambda index: 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cuda.reset_launches()

        def work():
            for _ in range(per_thread):
                cuda.launch("bitonic_sort", entry)
                sub.run(lambda a, *, tape: a, x)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=WAIT)
            assert not th.is_alive(), "a worker never finished"
        assert cuda.LAUNCHES["bitonic_sort"] == threads * per_thread
        assert sub.stats_snapshot()["runs"] == threads * per_thread
    finally:
        sys.setswitchinterval(interval)
        cuda._ENTRIES.pop(entry, None)
        cuda._device, cuda._raw_stream = saved
        cuda.reset_launches()
