"""Hierarchical span tracer -- where a call's time went, on the
profiler's clock.

Adapted from ``src/repro/obs/trace.py`` (the port imports nothing of
the reference package).  One instrumentation call, :func:`span`, feeds
two sinks:

* the **Tracer tree**: when a trace is open (:meth:`Tracer.trace`) the
  span is recorded as a child of the current one, as in the reference;
* the **torch profiler**: when ``torch.profiler`` is recording, the span
  also opens a ``record_function`` range named ``repro:<name>``, so
  the profiler's trace holds the program's spans beside its torch ops
  and device events (``portbench/spantrace.py`` reduces them to device
  busy and idle time a span).

Whether the profiler records is one flag read
(``torch.autograd._profiler_enabled``), never an opened range.  With
neither sink on, :func:`span` returns a shared ``nullcontext`` after one
ContextVar read and that flag read.

**The clock.**  Span and event stamps are seconds on the Unix epoch,
the clock of the profiler's host events: ``time.perf_counter_ns()``
plus one offset to ``time.time_ns()``, read once when a root opens and
shared by its whole tree.  So a ``chrome_trace`` of a tree lines up
with a kineto trace of the same window.

A traced ``cluster.sort`` gives this tree:

    q                                  (the caller's root: Tracer.trace;
    │                                   "query" under the query engine)
    └─ cluster.sort                    (the front door: algorithm, t, m,
       │                                payload_bytes)
       ├─ plan.sort                    (algorithm="auto": cache hit OR
       │  ├─ planner.sketch             sketch + score)
       │  │  └─ substrate.run
       │  │     └─ phase:round0 sketch
       │  └─ planner.score
       ├─ capacity.attempt             (one an attempt: attempt,
       │  │                             cap_factor, tile_slots, tile_bytes,
       │  │                             dropped)
       │  ├─ substrate.run
       │  │  ├─ phase:round1->2 samples
       │  │  ├─ phase:round2 boundaries
       │  │  └─ phase:round3 shuffle   (staged: "... s1" and "... s2")
       │  │     ├─ round3.pack         (the cut and the send tile)
       │  │     ├─ round3.all_to_all
       │  │     └─ round3.merge
       │  └─ sync:dropped
       ├─ sort.collect                 (the output rows)
       └─ sort.report                  (the tape's counts, count,
                                        boundaries)

``sync:<site>`` spans sit around every blocking device-to-host read on
the path (their number is the call's host syncs); ``kernel_dispatch``
events (``ops._tick``) land on the span open when a kernel wrapper is
called and ``capacity_retry`` events on the front door's.  A phase
span is opened live by ``CollectiveTape.phase``; after the run the
tape's per-machine ``sent``/``received`` arrays -- the numbers the
``AlphaKReport`` phases carry, bitwise -- are attached to it
(``substrate._attach_phases``).  The port's ctypes kernels
(``kernels/cuda.py:launch``) open a ``repro:launch:<kernel>`` profiler
range (no Tracer span) and fill a one-element marker in it first, so
their device events, which carry no correlation, can be put down to
their launch by stream order.

Threading contract
------------------
The trace context is an explicit object (:class:`Span`) carried in a
``contextvars.ContextVar``.  A *root* span is opened with
:meth:`Tracer.trace`; every instrumented layer below calls the
module-level :func:`span` / :func:`event`, which attach to the current
span **in the same thread**.  A span is only ever mutated by the
thread that opened it; the query engine opens each request's root in
the worker thread that runs it, so the whole tree lives there.

Overhead contract: with no active trace (the default: the process-global
tracer, :func:`get_tracer`, starts disabled) and no profiler recording,
every instrumentation point short-circuits before allocating anything,
and no device counter is read.
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

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

__all__ = ["Span", "SpanEvent", "Tracer", "get_tracer", "set_tracer",
           "enable", "disable", "current", "span", "event", "sync",
           "profiler_range", "RANGE_PREFIX"]

# the profiler ranges' names: RANGE_PREFIX + the span's name
RANGE_PREFIX = "repro:"

_IDS = itertools.count(1)


def _next_id(prefix: str) -> str:
    return f"{prefix}{next(_IDS):x}"


def _clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``: what turns the
    monotonic counter into the profiler's Unix-epoch clock."""
    return time.time_ns() - time.perf_counter_ns()


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
    Chrome exporter converts them to lists on the way out.  Stamps are
    Unix-epoch seconds: ``perf_counter_ns`` plus ``clock_offset_ns``,
    which a tree's spans share with its root.
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
    clock_offset_ns: int = dataclasses.field(
        default_factory=_clock_offset_ns, repr=False, compare=False)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_s - self.start_s)

    def now_s(self) -> float:
        """The current time on this span's clock."""
        return (time.perf_counter_ns() + self.clock_offset_ns) * 1e-9

    def add_event(self, name: str, **attrs) -> SpanEvent:
        ev = SpanEvent(name=name, ts_s=self.now_s(), attrs=attrs)
        self.events.append(ev)
        return ev

    def add_child(self, name: str, *, start_s: Optional[float] = None,
                  end_s: Optional[float] = None, **attrs) -> "Span":
        """Attach a pre-timed child (a phase with no live span: records
        taped outside every declared phase)."""
        now = self.now_s()
        child = Span(name=name, trace_id=self.trace_id,
                     span_id=_next_id("s"), parent_id=self.span_id,
                     start_s=now if start_s is None else start_s,
                     end_s=now if end_s is None else end_s, attrs=attrs,
                     clock_offset_ns=self.clock_offset_ns)
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
# active trace (None == no Tracer sink for this code path).
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)

_NULL = contextlib.nullcontext(None)


def current() -> Optional[Span]:
    """The innermost active span of the calling thread, or None."""
    return _CURRENT.get()


class _Range:
    """A ``repro:<name>`` profiler range alone (no trace open); yields
    None, as a span with no Tracer sink does."""
    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = record_function(RANGE_PREFIX + name)

    def __enter__(self):
        self._rf.__enter__()
        return None

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


class _ChildSpan:
    """A Tracer child span and, when the profiler records, its range.
    The profiler stamps a range at the end of its entry and of its exit
    calls, so the span's stamps are taken just after each."""
    __slots__ = ("_name", "_parent", "_attrs", "_rf", "_sp", "_token")

    def __init__(self, name: str, parent: Span, attrs: Dict[str, Any]):
        self._name, self._parent, self._attrs = name, parent, attrs

    def __enter__(self) -> Span:
        self._rf = None
        if _profiler_enabled():
            self._rf = record_function(RANGE_PREFIX + self._name)
            self._rf.__enter__()
        start_s = self._parent.now_s()
        parent = self._parent
        sp = Span(name=self._name, trace_id=parent.trace_id,
                  span_id=_next_id("s"), parent_id=parent.span_id,
                  start_s=start_s, attrs=self._attrs,
                  clock_offset_ns=parent.clock_offset_ns)
        parent.children.append(sp)
        self._sp, self._token = sp, _CURRENT.set(sp)
        return sp

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._sp.end_s = self._sp.now_s()
        _CURRENT.reset(self._token)
        return False


def span(name: str, **attrs):
    """Open a span under the current one, in whichever sinks are on.

    The instrumentation entry every layer uses::

        with obs_trace.span("substrate.run", body=label) as sp:
            ...            # sp is None when no trace is open

    Under an open trace ``sp`` is the new :class:`Span`; with the torch
    profiler recording a ``repro:<name>`` range spans the block too;
    with neither, this is a no-op.
    """
    parent = _CURRENT.get()
    if parent is not None:
        return _ChildSpan(name, parent, attrs)
    if _profiler_enabled():
        return _Range(name)
    return _NULL


def sync(site: str, on_card: bool):
    """A ``sync:<site>`` span around a read that blocks the host until
    the card has caught up (``on_card``: the tensor read lies on the
    card); a no-op for host tensors, whose reads block nothing."""
    return span("sync:" + site) if on_card else _NULL


def profiler_range(name: str):
    """A ``repro:<name>`` profiler range while the profiler records, no
    Tracer span: for points too frequent for the tree (kernel
    launches).  A no-op otherwise."""
    if _profiler_enabled():
        return _Range(name)
    return _NULL


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
                    span_id=_next_id("s"), attrs=attrs)
        root.start_s = root.now_s()
        token = _CURRENT.set(root)
        try:
            yield root
        finally:
            root.end_s = root.now_s()
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
