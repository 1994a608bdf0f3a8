"""Thread-safe metrics registry -- labeled counters.

The counter half of ``src/repro/obs/metrics.py`` (pure Python; the port
imports nothing of the reference package).  The port's kernel dispatch
(``repro_torch.kernels.ops._tick``) ticks ``kernel_dispatch_traces_total``
in the process-global :data:`REGISTRY` once a dispatch.  The
reference's gauges, histograms and text/JSON exporters have no reader
in the port yet; they come with the query-serving tier (ROADMAP A10).

Labels are keyword arguments; ``(name, sorted(labels))`` is the
instrument identity, so ``counter("x", op="sort")`` from two threads
returns the same object.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

__all__ = ["Counter", "MetricsRegistry", "REGISTRY", "get_registry",
           "reset_registry"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Named, labeled counters; identity = (name, sorted labels).

    One lock guards the instrument *directory*; each counter guards its
    own updates, so two threads bumping different counters never
    contend.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

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

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


# The process-global registry: the kernel dispatch counters live here.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def reset_registry() -> None:
    """Clear the global registry (tests; conftest calls this)."""
    REGISTRY.reset()
