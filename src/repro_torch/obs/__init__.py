"""Observability of the port (counterpart of ``repro.obs``): span
tracing, dispatch counters, timing.

* :mod:`repro_torch.obs.trace` -- hierarchical span tracer with a
  contextvar-carried trace context, threaded front door -> planner ->
  substrate -> tape phase -> kernel dispatch;
* :mod:`repro_torch.obs.metrics` -- thread-safe registry of labeled
  counters; backs the kernel dispatch counter;
* :mod:`repro_torch.obs.timeit` -- warmup + best-of-N timing that
  synchronizes the card.

The reference's process-global tracer, gauges, histograms and
exporters have no reader in the port yet; they come with the
query-serving tier (ROADMAP A10).
"""
from .trace import Span, SpanEvent, Tracer, current, event, span
from .metrics import (Counter, MetricsRegistry, REGISTRY, get_registry,
                      reset_registry)
from .timeit import TimeitResult, timeit

__all__ = [
    "Span", "SpanEvent", "Tracer", "current", "event", "span",
    "Counter", "MetricsRegistry", "REGISTRY", "get_registry",
    "reset_registry",
    "TimeitResult", "timeit",
]
