"""The traced window's device time by the program's own spans.

The program under test (``repro_torch.obs.trace``) opens a
``record_function`` range named ``repro:<span>`` around each span of
its call while torch.profiler records: the front door
(``cluster.sort``), each capacity attempt, each round (``phase:*``),
Round 3's steps, the output's collection and report, every blocking
host read (``sync:<site>``) and, with no Tracer span, every call of one
of its ctypes kernels (``launch:<kernel>``).  :func:`reduce_spans`
reads the same kineto events as ``devtrace.reduce_events`` and puts
down, on the host thread that made the calls:

* each device event (kernel, copy, memset) to the innermost span open
  when it was launched: a torch op's event through kineto's
  correlation to the op; an event with no correlation (the ctypes
  kernels' own) to its ``launch:`` range by stream order -- the
  program issues a one-element fill first inside each launch range,
  so the events with no correlation that follow that fill on the
  device (one stream) are the launch's own;
* each stretch of the window in which the device was idle to the
  innermost span(s) the host was in over that stretch, split by
  overlap.

Busy time is the union of the device events, as ``devtrace`` counts
it, so busy and idle seconds over all spans plus "no span" add up to
the trace's busy time and to the window less it.  A span's path is the
names of the spans open around it, outermost first, each without the
``repro:`` prefix; "no span" is the empty path.

:func:`install` makes ``devtrace.reduce_events`` attach this reduction
to the ``DeviceTrace`` it returns (as ``.spans``), so the per-layer
readers that use it find it on ``run.trace`` without a change to the
harness; every reader of these metrics calls it when it is loaded,
which the harness does before the window opens.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench import devtrace

__all__ = ["PREFIX", "NO_SPAN", "SpanTrace", "reduce_spans", "install",
           "spans_of", "per_call_ms", "under", "front_door"]

PREFIX = "repro:"
LAUNCH = "launch:"
NO_SPAN: Tuple[str, ...] = ()

Path = Tuple[str, ...]


@dataclasses.dataclass
class SpanTrace:
    """The window's device busy and idle time by span path (seconds)."""
    calls: int                  # the harness's calls in the window
    window_s: float
    busy_s: float               # union of the device events in the window
    busy: Dict[Path, float]     # innermost span's path -> busy seconds
    idle: Dict[Path, float]     # innermost span's path -> idle seconds
    syncs: int                  # ``sync:`` spans in the window
    fronts: int                 # ``cluster.sort`` spans in the window
    call_wall_s: float          # the calls' wall time, summed
    dropped_wall_s: float       # the attempts that dropped, summed
    uncorrelated: int           # device events with no correlation
    unmatched: int              # ... of them left to "no span"

    def busy_under(self, keep: Callable[[Path], bool]) -> float:
        return sum(v for p, v in self.busy.items() if keep(p))

    def idle_under(self, keep: Callable[[Path], bool]) -> float:
        return sum(v for p, v in self.idle.items() if keep(p))


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


class _Spans:
    """The program's ranges on one host thread, nested: each with its
    parent and path, and the thread's timeline cut where the innermost
    open range changes."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        ranges.sort(key=lambda r: (r[0], -r[1]))
        self.start = [r[0] for r in ranges]
        self.end = [r[1] for r in ranges]
        self.name = [r[2] for r in ranges]
        self.parent: List[Optional[int]] = []
        self.path: List[Path] = []
        # timeline: (segment start, segment end, innermost range or None)
        self.seg: List[Tuple[int, int, Optional[int]]] = []
        stack: List[int] = []
        cursor = -(1 << 62)
        for k, (s, e, name) in enumerate(ranges):
            while stack and self.end[stack[-1]] <= s:   # ranges nest
                top = stack.pop()
                cursor = self._emit(cursor, self.end[top], top)
            cursor = self._emit(cursor, s, stack[-1] if stack else None)
            parent = stack[-1] if stack else None
            self.parent.append(parent)
            self.path.append((self.path[parent] if parent is not None
                              else NO_SPAN) + (name,))
            stack.append(k)
        while stack:
            top = stack.pop()
            cursor = self._emit(cursor, self.end[top], top)
        self._emit(cursor, 1 << 62, None)
        self.seg_start = [s for s, _, _ in self.seg]

    def _emit(self, a: int, b: int, k: Optional[int]) -> int:
        if b > a:
            self.seg.append((a, b, k))
            return b
        return a

    def innermost(self, at: int) -> Optional[int]:
        """The innermost range open at host time ``at``."""
        k = bisect.bisect_right(self.start, at) - 1
        while k is not None and k >= 0 and self.end[k] < at:
            k = self.parent[k]
        return None if k is None or k < 0 else k

    def around(self, a: int, b: int) -> Optional[int]:
        """The innermost range open over all of [a, b]."""
        k = self.innermost(a)
        while k is not None and self.end[k] < b:
            k = self.parent[k]
        return k

    def holding(self, first: int, last: int) -> Optional[int]:
        """The innermost range that holds ranges ``first`` to ``last``
        (``first`` itself when they are one)."""
        k: Optional[int] = first
        while k is not None and self.end[k] < self.end[last]:
            k = self.parent[k]
        return k

    def path_of(self, k: Optional[int]) -> Path:
        return NO_SPAN if k is None else self.path[k]

    def split(self, g0: int, g1: int, into: Dict[Path, int]) -> None:
        """Add each part of [g0, g1) to the path of the innermost range
        the host was in over it."""
        i = bisect.bisect_right(self.seg_start, g0) - 1
        while i < len(self.seg) and self.seg[i][0] < g1:
            a, b, k = self.seg[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                into[self.path_of(k)] += part
            i += 1


def reduce_spans(events) -> Optional[SpanTrace]:
    """Reduce raw kineto events (``prof.profiler.kineto_results
    .events()``) to a :class:`SpanTrace`; None when the window holds no
    call."""
    host = []           # (start, end, name, thread, correlation id)
    device = []         # (start, end, name, linked correlation id)
    for ev in events:
        if _is_device(ev):
            if ev.is_user_annotation() or ev.name().startswith("portbench."):
                continue                    # a range drawn on the device
            device.append((ev.start_ns(), ev.end_ns(), ev.name(),
                           ev.linked_correlation_id()))
        elif ev.linked_correlation_id() == 0:   # a torch op or a range
            host.append((ev.start_ns(), ev.end_ns(), ev.name(),
                         ev.start_thread_id(), ev.correlation_id()))
    calls = [h for h in host if h[2] == devtrace.CALL]
    if not calls:
        return None
    w0 = min(h[0] for h in calls)
    w1 = max(h[1] for h in calls)
    thread = calls[0][3]
    device = sorted(d for d in device if d[1] > w0 and d[0] < w1
                    and "spin_kernel" not in d[2])
    spans = _Spans([(h[0], h[1], h[2][len(PREFIX):]) for h in host
                    if h[3] == thread and h[2].startswith(PREFIX)])
    by_corr = {h[4]: h for h in host if h[3] == thread}

    # each device event's launch: a torch op's start, or a launch range
    launch_at: List[Optional[int]] = [None] * len(device)   # host time
    owner: List[Optional[int]] = [None] * len(device)       # a range
    for i, d in enumerate(device):
        op = by_corr.get(d[3]) if d[3] else None
        if op is not None:
            launch_at[i] = op[0]
            owner[i] = spans.innermost(op[0])
    # a run of events with no correlation belongs to the launch range
    # whose marker (a correlated one-element fill the program issues
    # first inside the range) runs just before it.  With no marker (the
    # profiler loses an op's correlation now and then): to the one launch
    # range opened between its neighbours' ops, to the innermost span
    # that holds all of those, or with none to the innermost span open
    # over both neighbours' launches, which holds its own
    launches = [k for k in range(len(spans.name))
                if spans.name[k].startswith(LAUNCH)]
    launch_start = [spans.start[k] for k in launches]
    uncorrelated = unmatched = 0
    i = 0
    while i < len(device):
        if launch_at[i] is not None:
            i += 1
            continue
        j = i                               # the run [i, j) of events
        while j < len(device) and launch_at[j] is None:
            j += 1
        uncorrelated += j - i
        mark = owner[i - 1] if i > 0 else None
        if mark is None or not spans.name[mark].startswith(LAUNCH):
            before = launch_at[i - 1] if i > 0 else -(1 << 62)
            after = launch_at[j] if j < len(device) else 1 << 62
            lo = bisect.bisect_right(launch_start, before)
            hi = bisect.bisect_left(launch_start, after)
            mark = (spans.holding(launches[lo], launches[hi - 1])
                    if hi > lo else spans.around(before, after))
        if mark is None:
            unmatched += j - i              # left to "no span"
        for n in range(i, j):
            owner[n] = mark
        i = j

    # busy: the union of the events, each part to its event's span
    busy: Dict[Path, int] = collections.defaultdict(int)
    idle: Dict[Path, int] = collections.defaultdict(int)
    cur = w0
    for n, (s, e, _, _) in enumerate(device):
        s, e = max(s, w0), min(e, w1)
        if s > cur:
            spans.split(cur, s, idle)
        if e > max(s, cur):
            busy[spans.path_of(owner[n])] += e - max(s, cur)
        cur = max(cur, e)
    if w1 > cur:
        spans.split(cur, w1, idle)

    in_window = [k for k in range(len(spans.name))
                 if w0 <= spans.start[k] <= w1]
    fronts = [k for k in in_window if spans.name[k] == "cluster.sort"]
    attempts: Dict[int, List[int]] = collections.defaultdict(list)
    for k in in_window:
        if spans.name[k] == "capacity.attempt":
            front = spans.parent[k]
            while front is not None and spans.name[front] != "cluster.sort":
                front = spans.parent[front]
            if front is not None:
                attempts[front].append(k)
    # every attempt but a call's last dropped objects (the loop stops at
    # the first that drops none)
    dropped = sum(spans.end[k] - spans.start[k]
                  for ks in attempts.values() for k in sorted(ks)[:-1])
    return SpanTrace(
        calls=len(calls), window_s=(w1 - w0) / 1e9,
        busy_s=sum(busy.values()) / 1e9,
        busy={p: v / 1e9 for p, v in busy.items()},
        idle={p: v / 1e9 for p, v in idle.items()},
        syncs=sum(spans.name[k].startswith("sync:") for k in in_window),
        fronts=len(fronts),
        call_wall_s=sum(h[1] - h[0] for h in calls) / 1e9,
        dropped_wall_s=dropped / 1e9,
        uncorrelated=uncorrelated, unmatched=unmatched)


def install() -> None:
    """Make ``devtrace.reduce_events`` attach :func:`reduce_spans` of
    the same events to the ``DeviceTrace`` it returns, as ``.spans``.
    A reduction that raises fails the traced run.  Idempotent."""
    if getattr(devtrace.reduce_events, "with_spans", False):
        return
    plain = devtrace.reduce_events

    def reduce_events(events):
        events = list(events)
        trace = plain(events)
        trace.spans = reduce_spans(events)
        return trace

    reduce_events.with_spans = True
    devtrace.reduce_events = reduce_events


def spans_of(run) -> Optional[SpanTrace]:
    """The run's span reduction, where the program opened spans in it:
    None for an untraced run, off the card, or a program without them."""
    if run.op != "sort" or run.trace is None:
        return None
    st = getattr(run.trace, "spans", None)
    if st is None or st.fronts == 0:
        return None
    return st


def per_call_ms(run, idle: bool, keep: Callable[[Path], bool]
                ) -> Optional[float]:
    """Device busy (or idle) milliseconds a call under the spans whose
    path ``keep`` admits."""
    st = spans_of(run)
    if st is None:
        return None
    total = st.idle_under(keep) if idle else st.busy_under(keep)
    return 1e3 * total / st.calls


def under(name: str) -> Callable[[Path], bool]:
    """Paths inside a span named ``name`` (at any depth)."""
    return lambda path: name in path


def front_door(path: Path) -> bool:
    """Paths inside the front door (``cluster.sort``) but outside every
    capacity attempt: the input's checks, the output's collection and
    the report."""
    return "cluster.sort" in path and "capacity.attempt" not in path
