"""SLO-aware serving of the port: admission, deadlines, replicas, batching.

The reference's ``tests/test_serve_slo.py`` cases on the port's engine
(on the CPU), and the same event scripts through both packages'
admission queue, continuous batcher, length-bucket scheduler and pool
sizing, their outputs equal:

* no close()/submit() deadlock; shed-by-class, never up-class; typed
  shed errors and no hung tickets; a lone request on an idle engine
  dispatches at once; replicas sharing one pool and one result cache
  return the single engine's results, bitwise;
* ``_PriorityAdmission`` put/get/shed sequences, ``ContinuousBatcher``
  releases and due times, ``LengthBucketScheduler.plan`` and
  ``recommend_pool_size`` equal to the reference's on random scripts.

Every thread is joined with a timeout and every result waited on with
one.
"""
import queue
import threading
import time

import numpy as np
import pytest

from _prop import given, settings, st
from repro.cluster import recommend_pool_size as jrecommend_pool_size
from repro.serve import ContinuousBatcher as JContinuousBatcher
from repro.serve import LengthBucketScheduler as JLengthBucketScheduler
from repro.serve import sort_query as jsort_query
from repro.serve.query import _PriorityAdmission as JPriorityAdmission
from repro.serve.query import _Ticket as JTicket
from repro_torch import obs, planner
from repro_torch.cluster import reset_default_pool, recommend_pool_size
from repro_torch.data import uniform_keys
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import (PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL,
                               AdmissionError, ContinuousBatcher,
                               DeadlineExceededError, EngineClosedError,
                               EngineReplicas, LengthBucketScheduler,
                               QueryEngine, ResultTimeout, ShedError,
                               run_spec, sort_query)
from repro_torch.serve.query import (_AdmissionClosed, _PriorityAdmission,
                                     _Ticket, reset_serve_counters)

WAIT = 60.0


@pytest.fixture(autouse=True)
def _reset_port_state():
    def reset():
        planner.clear_plan_cache()
        reset_serve_counters()
        reset_default_pool()
        obs.reset_registry()
        obs.set_tracer(obs.Tracer(enabled=False))
    reset()
    yield
    reset()


def small_sort(t=2, m=64, seed=7, **kw):
    x = uniform_keys(t * m, seed=seed).reshape(t, m)
    return sort_query(x, algorithm="smms", **kw)


def ticket(priority, qid=0, deadline_s=None, submitted_at=0.0):
    spec = small_sort(seed=qid + 1, priority=priority,
                      deadline_s=deadline_s, tag=str(qid))
    return _Ticket(qid, spec, submitted_at)


def engine(**kw):
    return QueryEngine(device="cpu", **kw)


def joined(thread: threading.Thread, what: str) -> None:
    thread.join(timeout=5.0)
    assert not thread.is_alive(), what


# ---------------------------------------------------------------------------
# close() vs a submit() blocked on a full queue
# ---------------------------------------------------------------------------

def test_close_does_not_deadlock_with_blocked_submit():
    eng = engine(max_pending=2, autostart=False)
    for i in range(2):
        eng.submit(small_sort(seed=i + 1, tag=f"fill{i}"), block=False)
    blocked_exc = []
    entered = threading.Event()

    def blocked_submit():
        entered.set()
        try:
            eng.submit(small_sort(seed=99, tag="blocked"), block=True)
        except Exception as exc:
            blocked_exc.append(exc)

    submitter = threading.Thread(target=blocked_submit, daemon=True)
    submitter.start()
    assert entered.wait(2.0)
    time.sleep(0.05)          # let the submitter reach the blocking put
    closer = threading.Thread(target=eng.close, daemon=True)
    closer.start()
    joined(closer, "close() deadlocked against submit()")
    joined(submitter, "blocked submit() never woke up")
    assert len(blocked_exc) == 1
    assert isinstance(blocked_exc[0], EngineClosedError)


def test_close_fails_queued_tickets_no_hang():
    eng = engine(max_pending=4, autostart=False)
    tickets = [eng.submit(small_sort(seed=i + 1, tag=str(i)), block=False)
               for i in range(3)]
    eng.close()
    for t in tickets:
        res = t.result(timeout=1.0)
        assert not res.ok and "closed" in res.error


# ---------------------------------------------------------------------------
# Priority admission: shed-by-class semantics
# ---------------------------------------------------------------------------

def test_high_priority_evicts_newest_low_under_overload():
    eng = engine(max_pending=3, autostart=False)
    lows = [eng.submit(small_sort(seed=i + 1, priority=PRIORITY_LOW,
                                  tag=f"low{i}"), block=False)
            for i in range(3)]
    high = eng.submit(small_sort(seed=50, priority=PRIORITY_HIGH,
                                 tag="high"), block=False)
    shed = lows[-1]
    with pytest.raises(ShedError):
        shed.result(timeout=1.0)
    assert shed.status() == "shed"
    for kept in lows[:-1]:
        assert kept.status() == "queued"
    assert high.status() == "queued"
    stats = eng.stats()
    assert stats.shed == 1
    assert stats.shed_by_class.get("low") == 1
    assert obs_metrics.REGISTRY.counter_value(
        "serve_shed_total", **{"class": "low", "reason": "overload"}) == 1
    eng.close()


def test_same_class_cannot_displace_itself():
    eng = engine(max_pending=2, autostart=False)
    for i in range(2):
        eng.submit(small_sort(seed=i + 1, priority=PRIORITY_LOW,
                              tag=str(i)), block=False)
    with pytest.raises(AdmissionError):
        eng.submit(small_sort(seed=9, priority=PRIORITY_LOW, tag="x"),
                   block=False)
    with pytest.raises(AdmissionError):
        eng.submit(small_sort(seed=10, priority=PRIORITY_LOW + 5,
                              tag="worse"), block=False)
    assert eng.stats().rejected == 2
    eng.close()


def test_get_serves_best_class_first_fifo_within():
    adm = _PriorityAdmission(maxsize=8)
    order = [(PRIORITY_LOW, 0), (PRIORITY_HIGH, 1), (PRIORITY_NORMAL, 2),
             (PRIORITY_HIGH, 3), (PRIORITY_LOW, 4)]
    for prio, qid in order:
        adm.put(ticket(prio, qid))
    served = [adm.get(timeout=0).query_id for _ in range(len(order))]
    assert served == [1, 3, 2, 0, 4]


@settings(max_examples=20)
@given(st.integers(0, 2 ** 30), st.integers(2, 6))
def test_property_no_priority_inversion_in_shedding(seed, maxsize):
    rng = np.random.default_rng(seed)
    adm = _PriorityAdmission(maxsize=int(maxsize))
    queued = {}
    for qid in range(40):
        prio = int(rng.integers(0, 4))
        tk = ticket(prio, qid)
        if rng.random() < 0.25 and queued:
            got = adm.get(timeout=0)
            assert got is not None
            assert got.priority <= min(t.priority for t in queued.values())
            del queued[got.query_id]
        try:
            victim = adm.put(tk, block=False)
        except queue.Full:
            assert all(t.priority <= prio for t in queued.values())
            continue
        queued[qid] = tk
        if victim is not None:
            assert victim.priority > prio, \
                f"class {victim.priority} shed for class {prio}"
            del queued[victim.query_id]
        assert adm.qsize() <= maxsize
    assert adm.qsize() == len(queued)


def _admission_script(adm_cls, ticket_cls, spec_fn, seed, maxsize):
    """Run one random put/get/drain script; return what it observed."""
    rng = np.random.default_rng(seed)
    adm = adm_cls(maxsize=maxsize)
    log = []
    for qid in range(48):
        op = rng.random()
        if op < 0.3:
            got = adm.get(timeout=0)
            log.append(("get", None if got is None else got.query_id))
        elif op < 0.33:
            log.append(("drain", [t.query_id for t in adm.drain()]))
        else:
            prio = int(rng.integers(0, 4))
            tk = ticket_cls(qid, spec_fn(prio), 0.0)
            try:
                victim = adm.put(tk, block=False)
                log.append(("put", qid, None if victim is None
                            else victim.query_id))
            except queue.Full:
                log.append(("full", qid))
        log.append(("size", adm.qsize(), sorted(adm.depths().items()),
                    adm.peak))
    return log


@settings(max_examples=20)
@given(st.integers(0, 2 ** 30), st.integers(1, 6))
def test_admission_scripts_match_the_reference(seed, maxsize):
    x = np.zeros((2, 4), np.float32)
    ours = _admission_script(_PriorityAdmission, _Ticket,
                             lambda p: sort_query(x, priority=p), seed,
                             maxsize)
    ref = _admission_script(JPriorityAdmission, JTicket,
                            lambda p: jsort_query(x, priority=p), seed,
                            maxsize)
    assert ours == ref


def test_admission_close_wakes_blocked_producer():
    adm = _PriorityAdmission(maxsize=1)
    adm.put(ticket(PRIORITY_NORMAL, 0))
    woke = []

    def producer():
        try:
            adm.put(ticket(PRIORITY_NORMAL, 1), block=True)
        except _AdmissionClosed:
            woke.append(True)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    time.sleep(0.05)
    adm.close()
    joined(th, "a producer blocked on a closed queue")
    assert woke == [True]
    assert adm.get(timeout=0).query_id == 0
    with pytest.raises(_AdmissionClosed):
        adm.get(timeout=0)


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

def test_expired_deadline_sheds_with_typed_error():
    with engine(max_pending=8, max_batch=2) as eng:
        tk = eng.submit(small_sort(seed=3, deadline_s=0.0, tag="doomed"))
        with pytest.raises(DeadlineExceededError):
            tk.result(timeout=5.0)
        assert tk.status() == "expired"
        assert eng.stats().expired == 1
        assert obs_metrics.REGISTRY.counter_value(
            "serve_shed_total",
            **{"class": "normal", "reason": "deadline"}) == 1
        ok = eng.submit(small_sort(seed=4, deadline_s=120.0))
        assert ok.result(timeout=WAIT).ok


def test_ticket_status_and_result_timeout_carries_it():
    eng = engine(max_pending=4, autostart=False)
    tk = eng.submit(small_sort(seed=5), block=False)
    assert tk.status() == "queued"
    with pytest.raises(ResultTimeout) as info:
        tk.result(timeout=0.01)
    assert info.value.status == "queued"
    assert "queued" in str(info.value)
    eng.close()
    assert tk.status() == "failed"


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

def test_idle_engine_serves_immediately_despite_huge_window():
    with engine(max_pending=8, batch_window_s=5.0) as eng:
        t0 = time.monotonic()
        res = eng.submit(small_sort(seed=6)).result(timeout=WAIT)
        elapsed = time.monotonic() - t0
        assert res.ok
        assert elapsed < 4.0, \
            f"idle request waited for the window ({elapsed:.2f}s)"


def test_batcher_release_rules():
    cb = ContinuousBatcher(max_batch=2, window_s=1.0)
    cb.add("a", "a1", 10, now=0.0)
    cb.add("a", "a2", 12, now=0.1)
    out = cb.release(now=0.1)
    assert [(k, sorted(items)) for k, items in out] == [("a", ["a1", "a2"])]
    cb.add("b", "b1", 10, now=1.0)
    assert cb.release(now=1.5) == []
    assert cb.release(now=2.0) == [("b", ["b1"])]
    cb.add("c", "c1", 10, now=3.0)
    assert cb.release(now=3.0, idle=True) == [("c", ["c1"])]
    cb.mark_dispatched("d", now=4.0)
    cb.add("d", "d1", 10, now=4.0)
    assert cb.release(now=4.0) == [("d", ["d1"])]
    cb.mark_done("d")
    cb.mark_done("d")
    cb.add("d", "d2", 10, now=4.5)
    assert cb.release(now=4.5) == [("d", ["d2"])]
    cb.add("d", "d3", 10, now=6.0)
    assert cb.release(now=6.0) == []
    cb.add("e", "e1", 10, now=6.0, deadline_at=6.4)
    assert ("e", ["e1"]) in cb.release(now=6.0)
    assert cb.release(now=6.0, flush=True) == [("d", ["d3"])]
    assert cb.pending() == 0


def test_batcher_next_deadline():
    cb = ContinuousBatcher(max_batch=4, window_s=1.0)
    assert cb.next_deadline(now=0.0) is None
    cb.add("a", "a1", 10, now=0.0)
    assert cb.next_deadline(now=0.0) == pytest.approx(1.0)
    cb.add("b", "b1", 10, now=0.2, deadline_at=0.5)
    assert cb.next_deadline(now=0.2) == pytest.approx(0.5)
    cb.mark_dispatched("a", now=0.3)
    assert cb.next_deadline(now=0.3) == pytest.approx(0.3)


def test_batcher_splits_oversized_release_by_length():
    cb = ContinuousBatcher(max_batch=2, window_s=0.0)
    for i, size in enumerate([100, 5, 110, 6]):
        cb.add("k", f"i{i}", size, now=0.0)
    groups = cb.release(now=0.0)
    assert sorted(len(g) for _, g in groups) == [2, 2]
    assert {frozenset(g) for _, g in groups} == \
        {frozenset({"i1", "i3"}), frozenset({"i0", "i2"})}


def _batcher_script(cls, seed):
    """A random add/dispatch/done/release script on a clock that only
    moves forward; returns every release, due time and board size."""
    rng = np.random.default_rng(seed)
    cb = cls(max_batch=int(rng.integers(1, 5)),
             window_s=float(rng.choice([0.0, 0.5, 1.0])))
    now, log = 0.0, []
    for i in range(60):
        now += float(rng.choice([0.0, 0.1, 0.4, 1.1]))
        key = f"k{int(rng.integers(0, 3))}"
        op = rng.random()
        if op < 0.5:
            dl = (None if rng.random() < 0.7
                  else now + float(rng.choice([0.2, 0.8, 2.0])))
            cb.add(key, f"q{i}", int(rng.integers(1, 200)), now, dl)
        elif op < 0.6:
            cb.mark_dispatched(key, now)
        elif op < 0.7:
            cb.mark_done(key)
        else:
            log.append(("release", cb.release(
                now, idle=bool(rng.random() < 0.2),
                flush=bool(rng.random() < 0.05))))
        log.append((cb.next_deadline(now), cb.pending(), cb.inflight()))
    return log


@settings(max_examples=20)
@given(st.integers(0, 2 ** 30))
def test_batcher_scripts_match_the_reference(seed):
    assert (_batcher_script(ContinuousBatcher, seed)
            == _batcher_script(JContinuousBatcher, seed))


@settings(max_examples=20)
@given(st.integers(0, 2 ** 30), st.integers(0, 40))
def test_length_bucket_plans_match_the_reference(seed, n):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 4096, n).tolist()
    if n and rng.random() < 0.3:
        lengths = [lengths[0]] * n          # ties
    for max_batch, buckets in ((8, 4), (3, 2), (1, 1), (16, 6)):
        ours = LengthBucketScheduler(max_batch=max_batch, buckets=buckets)
        ref = JLengthBucketScheduler(max_batch=max_batch, buckets=buckets)
        plan = ours.plan(lengths)
        assert plan == ref.plan(lengths)
        assert sorted(i for b in plan for i in b) == list(range(n))
        assert all(len(b) <= max_batch for b in plan)
        if plan:
            assert (LengthBucketScheduler.padding_waste(lengths, plan)
                    == JLengthBucketScheduler.padding_waste(lengths, plan))


# ---------------------------------------------------------------------------
# Replicas: one front door, shared caches, exact results
# ---------------------------------------------------------------------------

def test_replicas_bitwise_match_single_engine(rng):
    t, m = 2, 96
    xs = [uniform_keys(t * m, seed=int(rng.integers(1 << 30))).reshape(t, m)
          for _ in range(3)]
    specs = [sort_query(x, algorithm="smms") for x in xs]
    specs += [sort_query(xs[0], algorithm="auto"),
              sort_query(xs[1], algorithm="terasort", seed=3)]
    direct = [run_spec(s, device="cpu") for s in specs]
    with engine() as single:
        alone = single.run(specs, timeout=WAIT)
    with EngineReplicas(replicas=3, max_pending=16, device="cpu") as fleet:
        results = fleet.run(specs, timeout=WAIT)
    assert all(r.ok for r in results)
    for res, one, (value, _) in zip(results, alone, direct):
        for got, own, want in zip(res.value, one.value, value):
            if want is None:
                assert got is None and own is None
                continue
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                          want.numpy().view(np.uint8))
            np.testing.assert_array_equal(got.numpy(), own.numpy())


def test_replicas_share_result_cache_and_pool(rng):
    t, m = 2, 64
    x = uniform_keys(t * m, seed=int(rng.integers(1 << 30))).reshape(t, m)
    spec = sort_query(x, algorithm="smms")
    with EngineReplicas(replicas=2, max_pending=16, device="cpu") as fleet:
        assert fleet.engines[0].results is fleet.engines[1].results
        assert fleet.engines[0].pool is fleet.engines[1].pool
        first = fleet.engines[0].submit(spec).result(timeout=WAIT)
        second = fleet.engines[1].submit(spec).result(timeout=WAIT)
        agg = fleet.stats()
        suggested = fleet.suggest_replicas()
    assert first.ok and second.ok and second.cached
    np.testing.assert_array_equal(first.value[0].numpy(),
                                  second.value[0].numpy())
    assert first.value[1] is second.value[1] is None
    assert agg.result_cache_hits >= 1
    assert agg.served == 2
    assert 1 <= suggested <= 64


def test_replica_routing_tries_siblings_on_full():
    fleet = EngineReplicas(replicas=2, max_pending=1, autostart=False,
                           device="cpu")
    tickets = [fleet.submit(small_sort(seed=i + 1, tag=str(i)),
                            block=False) for i in range(2)]
    assert len({id(t) for t in tickets}) == 2
    with pytest.raises(AdmissionError):
        fleet.submit(small_sort(seed=9, tag="x"), block=False)
    fleet.close()


# ---------------------------------------------------------------------------
# QPS-derived pool sizing
# ---------------------------------------------------------------------------

def test_recommend_pool_size():
    assert recommend_pool_size(100.0, 0.07, target_utilization=0.7) == 10
    assert recommend_pool_size(0.0, 1.0) == 1
    assert recommend_pool_size(-5.0, 0.1) == 1
    assert recommend_pool_size(1e9, 1.0, max_replicas=64) == 64
    with pytest.raises(ValueError):
        recommend_pool_size(1.0, 1.0, target_utilization=0.0)
    with pytest.raises(ValueError):
        recommend_pool_size(1.0, 1.0, max_replicas=0)


@settings(max_examples=20)
@given(st.floats(0.001, 1e4), st.floats(1e-6, 10.0),
       st.floats(0.05, 1.0))
def test_property_pool_size_monotone_bounded_and_the_references(qps, service,
                                                                util):
    n = recommend_pool_size(qps, service, target_utilization=util)
    assert n == jrecommend_pool_size(qps, service, target_utilization=util)
    assert 1 <= n <= 64
    n2 = recommend_pool_size(qps * 2, service, target_utilization=util)
    assert n2 >= min(n, 64) or n2 == 64
    n3 = recommend_pool_size(qps, service / 2, target_utilization=util)
    assert n3 <= n
    for cap in (1, 7):
        assert (recommend_pool_size(qps, service, target_utilization=util,
                                    max_replicas=cap)
                == jrecommend_pool_size(qps, service,
                                        target_utilization=util,
                                        max_replicas=cap))


# ---------------------------------------------------------------------------
# End-to-end: overload sheds by class, high-priority still served
# ---------------------------------------------------------------------------

def test_overload_sheds_low_serves_high():
    with engine(max_pending=4, max_batch=4) as eng:
        lows = [eng.submit(small_sort(seed=i + 1, priority=PRIORITY_LOW,
                                      tag=f"l{i}"), block=False)
                for i in range(4)]
        highs = []
        for i in range(3):
            try:
                highs.append(eng.submit(
                    small_sort(seed=100 + i, priority=PRIORITY_HIGH,
                               tag=f"h{i}"), block=False))
            except AdmissionError:
                pass
        assert highs, "no high-priority submit was admitted"
        outcomes = {"served": 0, "shed": 0}
        for tk in lows:
            try:
                res = tk.result(timeout=WAIT)
                assert res.ok
                outcomes["served"] += 1
            except ShedError:
                outcomes["shed"] += 1
        for tk in highs:
            assert tk.result(timeout=WAIT).ok
        stats = eng.stats()
        assert stats.shed == outcomes["shed"]
        assert stats.shed_by_class.get("high", 0) == 0
