"""Hierarchical span tracer -- where a call's wall-clock went.

A copy of ``src/repro/obs/trace.py`` (pure Python; the port imports
nothing of the reference package).  A traced ``cluster.sort`` gives a
tree of spans:

    q                                  (the caller's root: Tracer.trace;
                                        "query" under the query engine)
    ├─ plan.sort                       (algorithm="auto": cache hit OR
    │  ├─ planner.sketch                sketch + score)
    │  │  └─ substrate.run             (the sketch body)
    │  │     └─ phase:round0 sketch
    │  └─ planner.score
    └─ substrate.run                   (one per capacity attempt)
       ├─ phase:round1->2 samples      (leaf: taped counts, no host time)
       ├─ phase:round2 boundaries
       └─ phase:round3 shuffle         (staged: "... s1" and "... s2")

with ``kernel_dispatch`` events (``ops._tick``) on the span open when a
kernel wrapper is called and ``capacity_retry`` events from the retry
loop.

Threading contract
------------------
The trace context is an explicit object (:class:`Span`) carried in a
``contextvars.ContextVar``.  A *root* span is opened with
:meth:`Tracer.trace`; every instrumented layer below calls the
module-level :func:`span` / :func:`event`, which attach to the current
span **in the same thread** and are no-ops (one ContextVar read + a
None check) when no trace is active.  A span is only ever mutated by
the thread that opened it; the query engine opens each request's root
in the worker thread that runs it, so the whole tree lives there.

Leaf **phase spans** are attached after the substrate run from the
``CollectiveTape``: their per-machine ``sent``/``received`` arrays are
the same numbers the ``AlphaKReport`` phases carry, so span counts
reconcile bitwise with the report.  Phase time is not observed (the
phases' work is queued on the device together), so phase spans are
instants at the run's end carrying the traffic attributes.

Overhead contract: with no active trace (the default: the process-global
tracer, :func:`get_tracer`, starts disabled) every instrumentation
point short-circuits before allocating anything, and no device counter
is read.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "SpanEvent", "Tracer", "get_tracer", "set_tracer",
           "enable", "disable", "current", "span", "event"]

_IDS = itertools.count(1)


def _next_id(prefix: str) -> str:
    return f"{prefix}{next(_IDS):x}"


@dataclasses.dataclass
class SpanEvent:
    """A point-in-time annotation on a span (compile, retry, dispatch)."""
    name: str
    ts_s: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Span:
    """One node of a request's timeline tree.

    ``attrs`` values may be numpy arrays (the phase spans' taped
    counters keep their bound dtype so tests can compare bitwise); the
    Chrome exporter converts them to lists on the way out.
    """
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_s: float = 0.0
    end_s: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events: List[SpanEvent] = dataclasses.field(default_factory=list)
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_s - self.start_s)

    def add_event(self, name: str, **attrs) -> SpanEvent:
        ev = SpanEvent(name=name, ts_s=time.perf_counter(), attrs=attrs)
        self.events.append(ev)
        return ev

    def add_child(self, name: str, *, start_s: Optional[float] = None,
                  end_s: Optional[float] = None, **attrs) -> "Span":
        """Attach a pre-timed child (the post-hoc phase spans use this)."""
        now = time.perf_counter()
        child = Span(name=name, trace_id=self.trace_id,
                     span_id=_next_id("s"), parent_id=self.span_id,
                     start_s=now if start_s is None else start_s,
                     end_s=now if end_s is None else end_s, attrs=attrs)
        self.children.append(child)
        return child

    def walk(self) -> Iterator["Span"]:
        """Depth-first over this span and every descendant."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        """All descendants (incl. self) whose name starts with ``name``."""
        return [s for s in self.walk() if s.name.startswith(name)]

    def tree_str(self, *, indent: int = 0) -> str:
        """Human-readable tree."""
        us = self.duration_s * 1e6
        keys = ", ".join(
            f"{k}={v}" for k, v in self.attrs.items()
            if isinstance(v, (str, int, float, bool)))
        line = f"{'  ' * indent}{self.name}  [{us:.0f}us]" \
               + (f"  ({keys})" if keys else "")
        parts = [line]
        for ev in self.events:
            parts.append(f"{'  ' * (indent + 1)}@ {ev.name} {ev.attrs}")
        for c in self.children:
            parts.append(c.tree_str(indent=indent + 1))
        return "\n".join(parts)


# The explicit trace context: the innermost open span of this thread's
# active trace (None == tracing off for this code path).
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)

_NULL = contextlib.nullcontext(None)


def current() -> Optional[Span]:
    """The innermost active span of the calling thread, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def _child_cm(name: str, parent: Span, attrs: Dict[str, Any]):
    sp = Span(name=name, trace_id=parent.trace_id, span_id=_next_id("s"),
              parent_id=parent.span_id, start_s=time.perf_counter(),
              attrs=attrs)
    parent.children.append(sp)
    token = _CURRENT.set(sp)
    try:
        yield sp
    finally:
        sp.end_s = time.perf_counter()
        _CURRENT.reset(token)


def span(name: str, **attrs):
    """Open a child span under the current one; no-op without a trace.

    The instrumentation entry every layer uses::

        with obs_trace.span("substrate.run", body=label) as sp:
            ...            # sp is None when tracing is off
    """
    parent = _CURRENT.get()
    if parent is None:
        return _NULL
    return _child_cm(name, parent, attrs)


def event(name: str, **attrs) -> None:
    """Annotate the current span with an instant event; no-op otherwise."""
    cur = _CURRENT.get()
    if cur is not None:
        cur.add_event(name, **attrs)


class Tracer:
    """Collects finished request traces (bounded; newest kept).

    ``enabled=False`` makes :meth:`trace` a no-op context yielding None
    — the zero-overhead off switch.  The tracer is thread-safe: roots
    may be opened from any number of engine worker threads; each root's
    subtree is single-threaded by the threading contract above.
    """

    def __init__(self, *, enabled: bool = True, max_traces: int = 256):
        self.enabled = bool(enabled)
        self.traces: "deque[Span]" = deque(maxlen=int(max_traces))
        self._lock = threading.Lock()

    def trace(self, name: str, **attrs):
        """Open a ROOT span (a new trace) and make it current."""
        if not self.enabled:
            return _NULL
        return self._root_cm(name, attrs)

    @contextlib.contextmanager
    def _root_cm(self, name: str, attrs: Dict[str, Any]):
        root = Span(name=name, trace_id=_next_id("t"),
                    span_id=_next_id("s"), start_s=time.perf_counter(),
                    attrs=attrs)
        token = _CURRENT.set(root)
        try:
            yield root
        finally:
            root.end_s = time.perf_counter()
            _CURRENT.reset(token)
            with self._lock:
                self.traces.append(root)

    def last(self) -> Optional[Span]:
        with self._lock:
            return self.traces[-1] if self.traces else None

    def reset(self) -> None:
        with self._lock:
            self.traces.clear()

    def __repr__(self) -> str:
        return (f"Tracer(enabled={self.enabled}, "
                f"captured={len(self.traces)})")


# ---------------------------------------------------------------------------
# The process-global tracer: disabled by default (tracing is opt-in).
# ---------------------------------------------------------------------------
_GLOBAL = Tracer(enabled=False)
_GLOBAL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (what ``QueryEngine`` defaults to)."""
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = tracer
    return tracer


def enable() -> Tracer:
    """Turn the global tracer on (one-shot calls outside an engine can
    then open traces via ``get_tracer().trace(...)``)."""
    _GLOBAL.enabled = True
    return _GLOBAL


def disable() -> Tracer:
    _GLOBAL.enabled = False
    return _GLOBAL
