"""The port's observability against the reference's, on the CPU.

A traced ``cluster.sort``, with the spans the reference has not got
taken out (their children and events lifted to the nearest span kept:
:func:`reference_view`), must give the reference's span tree -- the
same span names, nested the same way -- with its ``phase:*`` spans
equal, bitwise, to the report's phases, and its ``kernel_dispatch``
events in the reference's op order (the reference's ``path`` labels
name JAX backends, so only the ops are compared).  The port's own
spans (the front door, each capacity attempt, Round 3's steps, the
output's collection and the report) are held to their exact shape.
Each span is also a ``repro:`` range when torch.profiler records, on
the profiler's clock.  With neither sink on no span is recorded, no
range opened, and the tape's device counters are read once, for the
report.  The counter registry and ``timeit`` are copies of the
reference's and are held to the reference's own tests, and the
registry's counters to the reference's on the same updates.
"""
import dataclasses
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro import obs as jobs
from repro.cluster.substrate import SubstratePool
from repro_torch import cluster, obs
from repro_torch.cluster import CapacityPolicy, CollectiveTape
from repro_torch.core.exchange import flat_receive_capacity
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry, Tracer, timeit

from test_torch_terasort import reference_uniforms


# the spans the port adds to the reference's tree
PORT_SPANS = ("cluster.sort", "capacity.attempt", "round3.", "sort.collect",
              "sort.report", "sync:")


def shape(span, depth=0):
    """The span tree as indented names."""
    return [("  " * depth) + span.name] + [
        line for c in span.children for line in shape(c, depth + 1)]


def reference_view(span, keep=lambda name: not name.startswith(PORT_SPANS)):
    """A copy of the tree with only the spans ``keep`` admits (by
    default: the reference's); a span left out hands its children and
    its events to the nearest span kept above it."""
    def lifted(sp):
        kids, events = [], list(sp.events)
        for c in sp.children:
            if keep(c.name):
                kids.append(reference_view(c, keep))
            else:
                more_kids, more_events = lifted(c)
                kids += more_kids
                events += more_events
        return kids, events

    kids, events = lifted(span)
    return dataclasses.replace(span, children=kids, events=events)


def dispatched_ops(root):
    """The tree's kernel_dispatch ops in the order they happened."""
    events = [e for s in root.walk() for e in s.events
              if e.name == "kernel_dispatch"]
    return [e.attrs["op"] for e in sorted(events, key=lambda e: e.ts_s)]


def assert_phases_are_the_report(root, report):
    """One substrate.run per attempt; the last one's live phase spans
    are the report's phases, bitwise, in the report's order."""
    runs = [s for s in reference_view(root).walk()
            if s.name == "substrate.run"]
    assert runs, root.tree_str()
    kids = runs[-1].children
    assert [c.name for c in kids] == [f"phase:{p.name}"
                                      for p in report.phases]
    for c, p in zip(kids, report.phases):
        assert c.duration_s > 0                       # opened live
        assert c.attrs["sent"].dtype == np.asarray(p.sent).dtype
        np.testing.assert_array_equal(c.attrs["sent"], p.sent)
        np.testing.assert_array_equal(c.attrs["received"], p.received)


def port_shape(algorithm, exchange, attempts=1):
    """The port's own tree of one traced sort on the CPU (no ``sync:``
    spans: host tensors' reads block nothing)."""
    if exchange == "flat":
        round3 = ["        phase:round3 shuffle", "          round3.pack",
                  "          round3.all_to_all", "          round3.merge"]
    else:
        round3 = ["        round3.pack", "        phase:round3 shuffle s1",
                  "        phase:round3 shuffle s2"]
    attempt = ["    capacity.attempt", "      substrate.run",
               "        phase:round1->2 samples",
               "        phase:round2 boundaries", *round3]
    return (["q", "  cluster.sort"] + attempt * attempts
            + ["    sort.collect", "    sort.report"])


def traced(fn):
    tracer = Tracer(enabled=True)
    with tracer.trace("q") as root:
        out = fn()
    assert tracer.last() is root
    return root, out


def traced_reference(fn):
    tracer = jobs.Tracer(enabled=True)
    with tracer.trace("q") as root:
        out = fn()
    return root, out


@pytest.mark.parametrize("kernel_backend", ["reference", "pallas"])
@pytest.mark.parametrize("exchange", ["flat", "staged"])
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_traced_sort_gives_the_reference_span_tree(algorithm, exchange,
                                                   kernel_backend):
    t, m = 8, 64
    x = np.random.default_rng(3).normal(size=(t, m)).astype(np.float32)
    kw = {"algorithm": algorithm, "exchange": exchange, "seed": 3}
    extra = ({"uniforms": reference_uniforms(3, t, m)}
             if algorithm == "terasort" else {})
    root, (_, report) = traced(lambda: cluster.sort(x, device="cpu",
                                                    **kw, **extra))
    jroot, _ = traced_reference(lambda: jcluster.sort(
        jnp.asarray(x), substrate=SubstratePool(),
        kernel_backend=kernel_backend, **kw))
    names = {s.name for s in jroot.walk()}
    assert shape(reference_view(root, names.__contains__)) == shape(jroot)
    assert shape(reference_view(root)) == shape(jroot)
    assert shape(root) == port_shape(algorithm, exchange)
    assert dispatched_ops(root) == dispatched_ops(jroot)
    assert {e.attrs["path"] for s in root.walk() for e in s.events
            if e.name == "kernel_dispatch"} == {"plain"}
    assert_phases_are_the_report(root, report)
    run = [s for s in root.walk() if s.name == "substrate.run"][0]
    body = "smms_shard" if algorithm == "smms" else "terasort_shard"
    assert run.attrs == {"body": body, "substrate": "BatchedSubstrate",
                         "t": t}
    front = root.children[0]
    assert front.attrs == {"algorithm": algorithm, "t": t, "m": m,
                           "payload_bytes": 0}
    [attempt] = front.find("capacity.attempt")
    assert attempt.attrs["dropped"] == 0 and attempt.attrs["attempt"] == 1
    assert attempt.attrs["cap_factor"] == report.cap_factor
    for sp in root.walk():      # children inside their parent, in order
        for a, b in zip(sp.children, sp.children[1:]):
            assert sp.start_s <= a.start_s <= a.end_s <= b.start_s
        if sp.children:
            assert sp.children[-1].end_s <= sp.end_s


def test_capacity_retries_are_the_reference_events():
    """A capacity too small to hold the shuffle: one substrate.run per
    attempt and a capacity_retry event per retry, the reference's."""
    t, m = 4, 64
    x = np.random.default_rng(1).normal(size=(t, m)).astype(np.float32)
    policy = CapacityPolicy(base_factor=0.3, max_retries=3)
    root, (_, report) = traced(lambda: cluster.sort(x, policy=policy,
                                                    device="cpu"))
    from repro.cluster import CapacityPolicy as JPolicy
    jroot, (_, jreport) = traced_reference(lambda: jcluster.sort(
        jnp.asarray(x), policy=JPolicy(base_factor=0.3, max_retries=3),
        substrate=SubstratePool()))
    assert report.capacity_attempts == jreport.capacity_attempts > 1

    def retries(r):
        return [e.attrs for e in r.events if e.name == "capacity_retry"]

    view = reference_view(root)
    assert retries(view) == retries(jroot) and retries(view)
    assert shape(view) == shape(jroot)
    assert_phases_are_the_report(root, report)


def test_auto_sort_traces_the_planner():
    from repro_torch.planner import clear_plan_cache
    clear_plan_cache()
    t, m = 8, 256
    x = np.random.default_rng(4).random((t, m)).astype(np.float32)
    root, (_, report) = traced(lambda: cluster.sort(x, algorithm="auto",
                                                    device="cpu"))
    assert shape(reference_view(root))[:5] == [
        "q", "  plan.sort", "    planner.sketch", "      substrate.run",
        "        phase:round0 sketch"]
    assert shape(root)[:6] == ["q", "  cluster.sort", "    plan.sort",
                               "      planner.sketch",
                               "        substrate.run",
                               "          phase:round0 sketch"]
    assert "      planner.score" in shape(root)
    assert root.children[0].attrs["algorithm"] == "auto"
    sketch = root.find("planner.sketch")[0].children[0].children[0]
    np.testing.assert_array_equal(sketch.attrs["sent"],
                                  report.sketch_phases[0].sent)
    root2, _ = traced(lambda: cluster.sort(x, algorithm="auto",
                                           device="cpu"))
    assert [e.name for e in root2.find("plan.sort")[0].events] == [
        "plan.cache_hit"]
    assert not root2.find("planner.sketch")
    clear_plan_cache()


def test_tracing_off_records_nothing_and_reads_the_tape_once(monkeypatch):
    """No trace open: no span, no event, and the tape's device counters
    are read once -- by the report -- as with no tracing at all."""
    reads = []
    phases = CollectiveTape.phases

    def counted(self, t):
        reads.append(t)
        return phases(self, t)

    monkeypatch.setattr(CollectiveTape, "phases", counted)
    x = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    tracer = Tracer(enabled=False)
    with tracer.trace("q") as root:
        assert root is None
        cluster.sort(x, device="cpu")
    assert not tracer.traces and tracer.last() is None
    assert reads == [4]
    with obs.span("orphan") as sp:
        obs.event("ignored")
        assert sp is None
    assert obs.current() is None
    reads.clear()
    traced(lambda: cluster.sort(x, device="cpu"))
    assert reads == [4, 4]                  # the span's phases, the report


def test_neither_sink_opens_a_range_or_reads_a_counter(monkeypatch):
    """No trace open and no profiler recording: ``span()`` opens no
    ``record_function`` and reads no tape counter (the report's one
    read is all); the profiler alone opens ranges and reads none
    either."""
    from repro_torch.obs import trace as obs_trace
    opened, reads = [], []
    real_rf, phases = obs_trace.record_function, CollectiveTape.phases

    def counting_rf(name, *a, **kw):
        opened.append(name)
        return real_rf(name, *a, **kw)

    def counted(self, t):
        reads.append(t)
        return phases(self, t)

    monkeypatch.setattr(obs_trace, "record_function", counting_rf)
    monkeypatch.setattr(CollectiveTape, "phases", counted)
    x = np.random.default_rng(6).normal(size=(4, 64)).astype(np.float32)
    assert obs.span("off") is obs.span("other")       # one shared no-op
    cluster.sort(x, device="cpu")
    assert opened == [] and reads == [4]
    reads.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        cluster.sort(x, device="cpu")
    assert reads == [4]
    assert opened[0] == "repro:cluster.sort" and len(opened) == len(
        port_shape("smms", "flat")) - 1


def test_profiler_ranges_are_the_spans_on_one_clock():
    """Under torch.profiler every span of a traced call is a
    ``repro:<name>`` range; a span's stamps are on the profiler's clock:
    the two agree within 50 us at each end (the median over the call's
    spans; the profiler's own cost of a range stands between them)."""
    t, m = 4, 64
    x = np.random.default_rng(7).normal(size=(t, m)).astype(np.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("warm-up"):        # the profiler's first range
            pass
        root, _ = traced(lambda: cluster.sort(x, device="cpu"))
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(obs.trace.RANGE_PREFIX)
                     and e.name() != "repro:warm-up"),
                    key=lambda e: e.start_ns())
    spans = list(root.walk())[1:]
    assert [e.name() for e in ranges] == [
        obs.trace.RANGE_PREFIX + s.name for s in spans]
    starts = np.array([e.start_ns() - s.start_s * 1e9
                       for e, s in zip(ranges, spans)]) / 1e3
    ends = np.array([e.end_ns() - s.end_s * 1e9
                     for e, s in zip(ranges, spans)]) / 1e3
    assert np.median(np.abs(starts)) < 50.0, starts
    assert np.median(np.abs(ends)) < 50.0, ends


def test_capacity_attempts_are_spans_with_the_loops_reads(monkeypatch):
    """A forced retry: one ``capacity.attempt`` span an attempt, its
    ``dropped`` the count the loop read, its tile's slots doubling with
    the factor and its bytes a key and a payload row a slot."""
    from repro_torch.core import smms
    seen = []
    real = smms.run_with_capacity

    def recording(attempt, policy):
        def recorded(factor):
            out, dropped = attempt(factor)
            seen.append(int(dropped))
            return out, dropped
        return real(recorded, policy)

    monkeypatch.setattr(smms, "run_with_capacity", recording)
    t, m = 4, 64
    x = np.random.default_rng(1).normal(size=(t, m)).astype(np.float32)
    v = np.arange(t * m * 3, dtype=np.int32).reshape(t, m, 3)
    policy = CapacityPolicy(base_factor=0.3, max_retries=3)
    root, (_, report) = traced(lambda: cluster.sort(
        x, values=v, policy=policy, device="cpu"))
    attempts = root.find("capacity.attempt")
    assert len(attempts) == report.capacity_attempts == len(seen) > 1
    assert [a.attrs["dropped"] for a in attempts] == seen
    assert seen[-1] == 0 and all(d > 0 for d in seen[:-1])
    assert [a.attrs["attempt"] for a in attempts] == list(
        range(1, len(seen) + 1))
    factors = [a.attrs["cap_factor"] for a in attempts]
    assert factors == list(policy.factors())[:len(seen)]
    for a, f in zip(attempts, factors):
        assert a.attrs["tile_slots"] == t * flat_receive_capacity(m, t, f)
        assert a.attrs["tile_bytes"] == a.attrs["tile_slots"] * (4 + 3 * 4)
    assert shape(root) == port_shape("smms", "flat", len(seen))
    assert root.children[0].attrs["payload_bytes"] == 12
    assert [e.attrs["attempt"] for e in root.children[0].events
            if e.name == "capacity_retry"] == list(range(2, len(seen) + 1))


# ---------------------------------------------------------------------------
# dispatch counters
# ---------------------------------------------------------------------------

def test_dispatch_ticks_the_registry_and_exec_counts():
    """Each dispatch ticks kernel_dispatch_traces_total as it ticks
    DISPATCH_COUNTS.  The port compiles no program, so a dispatch is an
    execution and these counts are the execution counts too: two runs
    count twice."""
    obs.reset_registry()
    ops.reset_dispatch_counts()
    x = np.random.default_rng(5).normal(size=(4, 64)).astype(np.float32)

    def registry():
        return {(dict(k)["op"], dict(k)["path"]): int(v)
                for k, v in obs.REGISTRY.counters_matching(
                    "kernel_dispatch_traces_total").items()}

    cluster.sort(x, device="cpu")
    one = dict(ops.DISPATCH_COUNTS)
    assert one and registry() == one
    cluster.sort(x, device="cpu")
    assert dict(ops.DISPATCH_COUNTS) == registry() == {
        k: 2 * v for k, v in one.items()}
    obs.reset_registry()
    assert registry() == {}


# ---------------------------------------------------------------------------
# registry, timeit: the reference's tests, and its counters
# ---------------------------------------------------------------------------

def test_registry_thread_safety():
    reg = MetricsRegistry()
    n_threads, per_thread = 8, 500
    errors = []

    def worker(k):
        try:
            for i in range(per_thread):
                reg.counter("stress_total", thread=str(k)).inc()
                reg.counter("stress_total_all").inc()
        except Exception as exc:  # pragma: no cover - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert reg.counter_value("stress_total_all") == n_threads * per_thread
    for k in range(n_threads):
        assert reg.counter_value("stress_total",
                                 thread=str(k)) == per_thread


def test_registry_counters_match_reference():
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("ticks_total", op="sort").inc(3)
        r.counter("ticks_total", op="search", path="plain").inc()
        r.counter("ticks_total", path="plain", op="search").inc(2)
        r.counter("other_total").inc()
    assert (reg.counters_matching("ticks_total")
            == jreg.counters_matching("ticks_total"))
    for labels in ({"op": "sort"}, {"op": "search", "path": "plain"},
                   {"op": "absent"}):
        assert (reg.counter_value("ticks_total", **labels)
                == jreg.counter_value("ticks_total", **labels))
    with pytest.raises(ValueError):
        reg.counter("ticks_total", op="sort").inc(-1)
    reg.reset()
    assert reg.counter_value("ticks_total", op="sort") == 0
    assert reg.counters_matching("other_total") == {}


def test_timeit_counts_and_setup(monkeypatch):
    calls, setups = [], []
    res = timeit(lambda: calls.append(1) or len(calls),
                 reps=3, warmup=2, setup=lambda: setups.append(1))
    assert len(calls) == 5 and len(setups) == 3
    assert res.reps == 3 and res.warmup == 2 and res.last_result == 5
    assert len(res.times_s) == 3 and 0.0 <= res.best_s <= res.mean_s
    assert res.best_us == pytest.approx(res.best_s * 1e6)
    with pytest.raises(ValueError):
        timeit(lambda: None, reps=0)

    def no_card(*a):
        raise AssertionError("synchronized for a result on the CPU")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    timeit(lambda: (torch.ones(3), {"k": [torch.zeros(2)]}), reps=2)

