"""The port's metrics, exporters and global tracer against the reference's.

Histograms, gauges and counters fed the same observations in both
packages give the same quantiles, means and snapshots, and the same
``to_json`` and ``to_prometheus_text``; ``chrome_trace`` of the same
span tree is the reference's document (the span ids too, when the
trees carry the same ids; a traced sort's document, the port's own
spans taken out, equal apart from ids, times and the instant events,
which in the reference name its JAX backends and compiles).  The
process-global tracer is off by default, and a query engine opens a
``query`` root per executed request whose ``substrate.run`` holds the
report's ``phase:*`` spans.
"""
import json
import math
import subprocess
import sys
import textwrap
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro_torch
from repro import cluster as jcluster
from repro import obs as jobs
from repro.cluster.substrate import SubstratePool as JSubstratePool
from repro_torch import cluster, obs, planner
from repro_torch.cluster import reset_default_pool
from repro_torch.obs import (Gauge, Histogram, MetricsRegistry, Span,
                             SpanEvent, Tracer, chrome_trace,
                             write_chrome_trace)
from repro_torch.serve import QueryEngine, sort_query
from repro_torch.serve.query import reset_serve_counters

from test_torch_obs import port_shape, reference_view

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


def _observations(seed: int, n: int) -> np.ndarray:
    """Latency-like values across the buckets, with exact bucket edges,
    zeros and values past the last finite bound."""
    rng = np.random.default_rng(seed)
    v = 10.0 ** rng.uniform(-7, 2, n)
    edges = np.asarray(obs.metrics.default_latency_buckets())
    if n >= 16:
        v[: n // 8] = rng.choice(edges, n // 8)
        v[n // 8: n // 8 + 2] = [0.0, 100.0]
    return v


@pytest.mark.parametrize("seed, n", [(0, 1), (1, 7), (2, 200), (3, 5000)])
def test_histogram_equals_the_reference(seed, n):
    ours, ref = Histogram(), jobs.Histogram()
    assert ours.quantile(0.5) == ref.quantile(0.5) == 0.0
    assert ours.mean == ref.mean == 0.0
    for v in _observations(seed, n):
        ours.observe(v)
        ref.observe(v)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == ref.quantile(q), q
    assert ours.mean == ref.mean
    assert ours.snapshot() == ref.snapshot()
    assert ours.uppers == ref.uppers
    with pytest.raises(ValueError):
        ours.quantile(1.5)
    custom, jcustom = Histogram([0.5, 0.1, 2.0]), jobs.Histogram([0.5, 0.1,
                                                                  2.0])
    for v in (0.05, 0.1, 0.3, 3.0, 1.0):
        custom.observe(v)
        jcustom.observe(v)
    assert custom.snapshot() == jcustom.snapshot()
    assert custom.quantile(0.7) == jcustom.quantile(0.7)


def test_gauge_equals_the_reference():
    ours, ref = Gauge(), jobs.Gauge()
    for g in (ours, ref):
        g.set(3)
        g.add(-1.5)
        g.add()
    assert ours.value == ref.value == 2.5


def _feed(reg, seed: int) -> None:
    """One script of counter, gauge and histogram updates."""
    rng = np.random.default_rng(seed)
    for i in range(60):
        op = int(rng.integers(0, 3))
        cls = str(rng.choice(["high", "normal", "low"]))
        if op == 0:
            reg.counter("serve_requests_total", **{"class": cls,
                                                   "outcome": "served"}
                        ).inc(float(rng.integers(1, 4)))
        elif op == 1:
            reg.gauge("queue_depth", engine=str(i % 2)).set(
                float(rng.integers(0, 9)))
        else:
            reg.histogram("serve_request_latency_seconds",
                          **{"class": cls}).observe(
                float(10.0 ** rng.uniform(-5, 0)))
    reg.histogram("serve_exec_seconds").observe(0.25)
    reg.counter("kernel_dispatch_traces_total", op="sort",
                path="plain").inc()


@pytest.mark.parametrize("seed", [0, 1])
def test_exporters_equal_the_reference(seed):
    ours, ref = MetricsRegistry(), jobs.MetricsRegistry()
    assert ours.to_prometheus_text() == ref.to_prometheus_text() == ""
    _feed(ours, seed)
    _feed(ref, seed)
    assert ours.to_json() == ref.to_json()
    assert ours.to_prometheus_text() == ref.to_prometheus_text()
    assert json.loads(ours.to_json())["histograms"]
    got = ours.histograms_matching("serve_request_latency_seconds")
    want = ref.histograms_matching("serve_request_latency_seconds")
    assert sorted(got) == sorted(want)
    for labels in got:
        assert got[labels].snapshot() == want[labels].snapshot()
        assert got[labels].quantile(0.99) == want[labels].quantile(0.99)
    ours.reset()
    assert ours.to_json() == MetricsRegistry().to_json()


def _tree(span_cls, event_cls, attrs_extra=None):
    """One span tree with fixed ids and times: a root with a timed
    child, a zero-length phase child holding arrays, and events."""
    phase = span_cls(name="phase:round3 shuffle", trace_id="t1",
                     span_id="s3", parent_id="s2", start_s=2.0, end_s=2.0,
                     attrs={"sent": np.arange(4, dtype=np.int32),
                            "received": np.int64(7), **(attrs_extra or {})})
    run = span_cls(name="substrate.run", trace_id="t1", span_id="s2",
                   parent_id="s1", start_s=1.0, end_s=2.0,
                   attrs={"body": "smms_shard", "t": 4},
                   events=[event_cls(name="kernel_dispatch", ts_s=1.5,
                                     attrs={"op": "sort", "path": "x"})],
                   children=[phase])
    return span_cls(name="query", trace_id="t1", span_id="s1", start_s=0.5,
                    end_s=2.5, attrs={"kind": "sort", "nested": {"a": (1, 2)},
                                      "obj": None},
                    events=[event_cls(name="capacity_retry", ts_s=1.0,
                                      attrs={"attempt": 2})],
                    children=[run])


def test_chrome_trace_equals_the_reference(tmp_path):
    ours = chrome_trace(_tree(Span, SpanEvent))
    ref = jobs.chrome_trace(_tree(jobs.Span, jobs.SpanEvent))
    assert ours == ref
    assert chrome_trace([_tree(Span, SpanEvent)] * 2) == \
        jobs.chrome_trace([_tree(jobs.Span, jobs.SpanEvent)] * 2)
    # a tensor attribute renders as the numpy array it holds would
    tensor = chrome_trace(_tree(Span, SpanEvent,
                                {"device": torch.arange(3)}))
    numpy = jobs.chrome_trace(_tree(jobs.Span, jobs.SpanEvent,
                                    {"device": np.arange(3)}))
    assert tensor == numpy
    path = write_chrome_trace(str(tmp_path / "q.json"),
                              _tree(Span, SpanEvent))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(ours))


def _without_ids(doc):
    """The spans' events as (ph, name, cat, args), ids and times left
    out.  Instant events on spans are not compared: the reference's
    name JAX backends and its compiles.  A phase span's ``ph`` is not
    compared either: the reference's phases are instants, the port's
    are opened live and have a duration."""
    drop = {"span_id", "parent_id"}
    out = []
    for e in doc["traceEvents"]:
        if e.get("cat") != "span":
            continue
        args = {k: v for k, v in e["args"].items() if k not in drop}
        ph = None if e["name"].startswith("phase:") else e["ph"]
        out.append((ph, e["name"], e.get("cat"), args))
    return out


def test_chrome_trace_of_a_traced_sort_equals_the_reference():
    """The port's document, its own spans taken out, is the
    reference's; the whole document holds the port's tree, each span a
    complete event on the profiler's clock."""
    t, m = 4, 64
    x = np.random.default_rng(3).normal(size=(t, m)).astype(np.float32)
    tracer, jtracer = Tracer(enabled=True), jobs.Tracer(enabled=True)
    before = time.time()
    with tracer.trace("q"):
        cluster.sort(x, device="cpu")
    after = time.time()
    with jtracer.trace("q"):
        jcluster.sort(jnp.asarray(x), substrate=JSubstratePool())
    ours = chrome_trace(reference_view(tracer.last()))
    ref = jobs.chrome_trace(jtracer.last())
    for doc in (ours, ref):
        for e in doc["traceEvents"]:
            if e["name"] == "substrate.run":
                e["args"].pop("substrate"), e["args"].pop("body")
    assert _without_ids(ours) == _without_ids(ref)
    whole = [e for e in chrome_trace(tracer.last())["traceEvents"]
             if e.get("cat") == "span"]
    assert [e["name"] for e in whole] == [
        line.strip() for line in port_shape("smms", "flat")]
    assert {e["ph"] for e in whole} == {"X"}
    assert all(before * 1e6 <= e["ts"] <= e["ts"] + e["dur"] <= after * 1e6
               for e in whole)


def test_global_tracer_is_off_by_default():
    code = textwrap.dedent("""
        from repro_torch import obs
        print(obs.get_tracer().enabled, obs.get_tracer().traces == type(
            obs.get_tracer().traces)())
    """)
    src = str(__import__("pathlib").Path(repro_torch.__file__).parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": src},
                         timeout=120)
    assert out.stdout.split() == ["False", "True"]
    tracer = Tracer(enabled=False)
    assert obs.set_tracer(tracer) is obs.get_tracer() is tracer
    assert obs.enable() is tracer and tracer.enabled
    assert obs.disable() is tracer and not tracer.enabled


def test_engine_query_spans_hold_the_runs_phases():
    x = np.random.default_rng(9).random((4, 128)).astype(np.float32)
    spec = sort_query(x, algorithm="auto")
    with QueryEngine(device="cpu") as eng:           # the global tracer: off
        [r] = eng.run([spec], timeout=WAIT)
    assert r.ok and r.trace is None and r.trace_id is None
    obs.enable()
    with QueryEngine(device="cpu", max_batch=4, batch_window_s=0.05) as eng:
        first, twin = eng.run([spec, spec], timeout=WAIT)
        [hit] = eng.run([spec], timeout=WAIT)
    root = first.trace
    assert root.name == "query" and root.trace_id == first.trace_id
    assert root.attrs["kind"] == "sort"
    assert obs.get_tracer().last() is root
    assert twin.coalesced and twin.trace is root
    assert hit.cached and hit.trace is None
    assert [c.name for c in root.children] == ["cluster.sort"]
    assert [c.name for c in root.children[0].children] == [
        "plan.sort", "capacity.attempt", "sort.collect", "sort.report"]
    view = reference_view(root)
    assert [c.name for c in view.children] == ["plan.sort", "substrate.run"]
    run = view.children[1]
    assert [c.name for c in run.children] == [
        f"phase:{p.name}" for p in first.report.phases]
    for c, p in zip(run.children, first.report.phases):
        np.testing.assert_array_equal(c.attrs["sent"], p.sent)
        np.testing.assert_array_equal(c.attrs["received"], p.received)
    assert math.isfinite(root.duration_s) and root.duration_s > 0
    doc = chrome_trace(root)
    assert [e["name"] for e in doc["traceEvents"]
            if e["ph"] == "X"][:3] == ["query", "cluster.sort", "plan.sort"]
