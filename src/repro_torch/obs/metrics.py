"""Thread-safe metrics registry -- counters, gauges, streaming histograms.

A copy of ``src/repro/obs/metrics.py`` (pure Python; the port imports
nothing of the reference package).  :class:`MetricsRegistry` hands out
named, labeled instruments, each safe to update from any thread.  The
query engine (``repro_torch.serve.query``) reads its request counters
and latency percentiles from an engine-local registry into
``ServeStats`` and ticks ``serve_shed_total`` in the process-global
:data:`REGISTRY`; the kernel dispatch (``repro_torch.kernels.ops._tick``)
ticks ``kernel_dispatch_traces_total`` there once a dispatch.

* **Labels** are keyword arguments; ``(name, sorted(labels))`` is the
  instrument identity, so ``counter("x", op="sort")`` from two threads
  returns the same object.
* **Histograms are streaming**: observations land in geometric buckets
  (plus exact count/sum/min/max), so quantiles are O(buckets) at read
  time however many observations arrived.  Quantiles interpolate
  linearly inside the winning bucket and clamp to the observed min/max.
* **Exporters**: ``to_prometheus_text()`` (the text exposition format:
  counters, gauges, and histograms with cumulative ``_bucket`` lines)
  and ``to_json()``.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "get_registry", "reset_registry",
           "default_latency_buckets"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotone counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, pool size)."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def default_latency_buckets() -> List[float]:
    """Geometric bounds 1us..~64s, factor sqrt(2) (~52 finite buckets).

    Each bucket's upper bound is at most sqrt(2)x its lower bound, so a
    within-bucket interpolated quantile is within ~20% of the true
    value.
    """
    out, b = [], 1e-6
    while b < 64.0:
        out.append(b)
        b *= math.sqrt(2.0)
    return out


class Histogram:
    """Streaming histogram: geometric buckets + exact count/sum/min/max."""

    def __init__(self, buckets: Optional[List[float]] = None) -> None:
        ub = sorted(buckets) if buckets else default_latency_buckets()
        self.uppers: List[float] = list(ub) + [math.inf]
        self.counts: List[int] = [0] * len(self.uppers)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        # binary search for the first upper bound >= v
        lo, hi = 0, len(self.uppers) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.uppers[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile of everything observed so far.

        O(buckets); returns 0.0 before the first observation.  Exact at
        the extremes (clamped to the tracked min/max), monotone in q.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            seen = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if seen + c >= rank:
                    lower = self.uppers[i - 1] if i > 0 else 0.0
                    upper = self.uppers[i]
                    if math.isinf(upper):
                        upper = self.max
                    frac = (rank - seen) / c
                    v = lower + (upper - lower) * max(0.0, min(1.0, frac))
                    return max(self.min, min(self.max, v))
                seen += c
            return self.max

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "min": self.min if self.count else 0.0,
                    "max": self.max if self.count else 0.0,
                    "buckets": {("+Inf" if math.isinf(u) else repr(u)): c
                                for u, c in zip(self.uppers, self.counts)
                                if c}}


class MetricsRegistry:
    """Named, labeled instruments; identity = (name, sorted labels).

    One lock guards the instrument *directory*; each instrument guards
    its own updates, so two threads bumping different counters never
    contend.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}
        # bumped by reset(): a caller that keeps an instrument for speed
        # (``ops._tick``) looks it up again in the next generation
        self.generation = 0

    # ---- instrument access -------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            return g

    def histogram(self, name: str, *,
                  buckets: Optional[List[float]] = None,
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(buckets)
            return h

    def counter_value(self, name: str, **labels) -> float:
        """Read without creating: 0.0 for a counter never ticked."""
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
        return c.value if c is not None else 0.0

    def counters_matching(self, name: str) -> Dict[LabelKey, float]:
        """All label-variants of one counter name (report tables)."""
        with self._lock:
            items = [(k, c) for k, c in self._counters.items()
                     if k[0] == name]
        return {k[1]: c.value for k, c in items}

    def histograms_matching(self, name: str) -> Dict[LabelKey, Histogram]:
        """All label-variants of one histogram name (per-class latency
        tables: the values are the live Histogram objects, so callers
        read quantiles without copying bucket arrays)."""
        with self._lock:
            return {k[1]: h for k, h in self._histograms.items()
                    if k[0] == name}

    def reset(self) -> None:
        with self._lock:
            self.generation += 1
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # ---- exporters ----------------------------------------------------
    def to_json(self) -> str:
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        doc: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for (name, labels), c in counters:
            doc["counters"][name + _label_str(labels)] = c.value
        for (name, labels), g in gauges:
            doc["gauges"][name + _label_str(labels)] = g.value
        for (name, labels), h in hists:
            doc["histograms"][name + _label_str(labels)] = h.snapshot()
        return json.dumps(doc, indent=2, sort_keys=True)

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (one TYPE line per metric name)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        lines: List[str] = []
        seen_type = set()

        def typed(name: str, kind: str) -> None:
            if name not in seen_type:
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)

        for (name, labels), c in counters:
            typed(name, "counter")
            lines.append(f"{name}{_label_str(labels)} {c.value:g}")
        for (name, labels), g in gauges:
            typed(name, "gauge")
            lines.append(f"{name}{_label_str(labels)} {g.value:g}")
        for (name, labels), h in hists:
            typed(name, "histogram")
            cum = 0
            for upper, cnt in zip(h.uppers, h.counts):
                cum += cnt
                le = "+Inf" if math.isinf(upper) else f"{upper:g}"
                lk = _label_key(dict(labels) | {"le": le})
                lines.append(f"{name}_bucket{_label_str(lk)} {cum}")
            lines.append(f"{name}_sum{_label_str(labels)} {h.sum:g}")
            lines.append(f"{name}_count{_label_str(labels)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# The process-global registry: the kernel dispatch counters and the
# serving tier's shed counters live here; engines keep their own
# private registries for per-engine stats.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def reset_registry() -> None:
    """Clear the global registry (tests; conftest calls this)."""
    REGISTRY.reset()
