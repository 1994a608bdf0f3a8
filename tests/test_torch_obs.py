"""The port's observability against the reference's, on the CPU.

A traced ``cluster.sort`` must give the reference's span tree -- the
same span names, nested the same way -- with its ``phase:*`` children
equal, bitwise, to the report's phases, and its ``kernel_dispatch``
events in the reference's op order (the reference's ``path`` labels
name JAX backends, so only the ops are compared).  With tracing off no
span is recorded and the tape's device counters are read once, for the
report.  The counter registry and ``timeit`` are copies of the
reference's and are held to the reference's own tests, and the
registry's counters to the reference's on the same updates.
"""
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
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry, Tracer, timeit

from test_torch_terasort import reference_uniforms


def shape(span, depth=0):
    """The span tree as indented names."""
    return [("  " * depth) + span.name] + [
        line for c in span.children for line in shape(c, depth + 1)]


def dispatched_ops(root):
    return [e.attrs["op"] for s in root.walk() for e in s.events
            if e.name == "kernel_dispatch"]


def assert_phases_are_the_report(root, report):
    """One substrate.run per attempt; the last one's phase children are
    the report's phases, bitwise."""
    runs = [s for s in root.walk() if s.name == "substrate.run"]
    assert runs, root.tree_str()
    kids = runs[-1].children
    assert [c.name for c in kids] == [f"phase:{p.name}"
                                      for p in report.phases]
    for c, p in zip(kids, report.phases):
        assert c.attrs["sent"].dtype == np.asarray(p.sent).dtype
        np.testing.assert_array_equal(c.attrs["sent"], p.sent)
        np.testing.assert_array_equal(c.attrs["received"], p.received)


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
    assert shape(root) == shape(jroot)
    assert dispatched_ops(root) == dispatched_ops(jroot)
    assert {e.attrs["path"] for s in root.walk() for e in s.events
            if e.name == "kernel_dispatch"} == {"plain"}
    assert_phases_are_the_report(root, report)
    run = [s for s in root.walk() if s.name == "substrate.run"][0]
    body = "smms_shard" if algorithm == "smms" else "terasort_shard"
    assert run.attrs == {"body": body, "substrate": "BatchedSubstrate",
                         "t": t}


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

    assert retries(root) == retries(jroot) and retries(root)
    assert shape(root) == shape(jroot)
    assert_phases_are_the_report(root, report)


def test_auto_sort_traces_the_planner():
    from repro_torch.planner import clear_plan_cache
    clear_plan_cache()
    t, m = 8, 256
    x = np.random.default_rng(4).random((t, m)).astype(np.float32)
    root, (_, report) = traced(lambda: cluster.sort(x, algorithm="auto",
                                                    device="cpu"))
    assert shape(root)[:5] == ["q", "  plan.sort", "    planner.sketch",
                               "      substrate.run",
                               "        phase:round0 sketch"]
    assert "    planner.score" in shape(root)
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

