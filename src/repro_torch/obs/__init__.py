"""Observability of the port (counterpart of ``repro.obs``): span
tracing, metrics, exporters, timing.

* :mod:`repro_torch.obs.trace` -- hierarchical span tracer with a
  contextvar-carried trace context, threaded request -> planner ->
  substrate -> tape phase -> kernel dispatch, and the process-global
  tracer (disabled by default) that the query engine opens its
  ``query`` roots on;
* :mod:`repro_torch.obs.metrics` -- thread-safe registry of counters,
  gauges and streaming histograms with Prometheus-text / JSON
  exporters; backs ``ServeStats`` and the kernel dispatch counter;
* :mod:`repro_torch.obs.export` -- Chrome-trace / Perfetto JSON export
  of span trees;
* :mod:`repro_torch.obs.timeit` -- warmup + best-of-N timing that
  synchronizes the card.
"""
from .trace import (Span, SpanEvent, Tracer, current, disable, enable,
                    event, get_tracer, set_tracer, span)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      REGISTRY, get_registry, reset_registry)
from .export import chrome_trace, write_chrome_trace
from .timeit import TimeitResult, timeit

__all__ = [
    "Span", "SpanEvent", "Tracer", "current", "disable", "enable",
    "event", "get_tracer", "set_tracer", "span",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry", "reset_registry",
    "chrome_trace", "write_chrome_trace",
    "TimeitResult", "timeit",
]
