"""The traced window: torch.profiler around the measured calls, and its
reduction to device busy time, device time a wrapped entry, and the
breakdown of device operations and idle gaps.

The harness marks every call with a ``record_function`` range named
:data:`CALL` and, in a traced run, every call of a wrapped program
entry (``module:function``) with :data:`ENTRY` + the entry's name.
Inside the entry's range, just before and just after the entry runs,
it launches a one-element fill (:func:`mark`) under a :data:`MARK`
range.  The run issues everything on one stream, so the device events
that lie between an entry call's two marks in the device's order are
the ones that call launched: torch ops, the port's own kernels (which
``ctypes`` launches through a cudart that kineto does not trace, so
they carry no correlation to a host event) and their copies and
memsets alike.  A kernel swapped in behind the same entry is timed by
the same rule, whatever its name.

The window opens with a spin kernel (``torch.cuda._sleep``) that runs
before the first call and is left out: without it a profiled window of
a few calls lost some or all of their kernels' events on the card.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["CALL", "ENTRY", "MARK", "SPIN_CYCLES", "DeviceTrace",
           "open_window", "close_window", "mark", "reduce_events"]

CALL = "portbench.call"
ENTRY = "portbench.entry:"
MARK = "portbench.mark"
SPIN_CYCLES = 50_000_000        # ~25 ms of clock cycles before the calls
TOP = 10                        # entries in each list of the breakdown
NAME_CHARS = 120                # a device op's name, cut to this length
SCAN = 4096                     # host events scanned back to find a gap's


@dataclasses.dataclass
class DeviceTrace:
    """What the traced window read on the device."""
    window_s: float                         # first call's start to last end
    busy_s: float                           # union of device events in it
    entry_device_s: Dict[str, float]        # entry -> device seconds
    device_ops: List[Tuple[str, float]]     # top device ops by seconds
    idle_gaps: List[Tuple[str, float]]      # idle seconds by host activity
    device_events: int

    @property
    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or self.device_events == 0:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s / self.window_s)


def mark(flag: torch.Tensor) -> None:
    """One tiny kernel on the current stream, under a :data:`MARK` range."""
    with torch.profiler.record_function(MARK):
        flag.fill_(1)


def open_window():
    """Start the profiler, run the spin kernel and wait for it; the
    calls start after this returns."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    return prof


def close_window(prof) -> DeviceTrace:
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof.stop()
    return reduce_events(prof.profiler.kineto_results.events())


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def reduce_events(events) -> DeviceTrace:
    """Reduce raw kineto events (``prof.profiler.kineto_results
    .events()``) to a :class:`DeviceTrace`."""
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
    calls = [h for h in host if h[2] == CALL]
    if not calls:
        return DeviceTrace(0.0, 0.0, {}, [], [], 0)
    w0 = min(h[0] for h in calls)
    w1 = max(h[1] for h in calls)
    thread = calls[0][3]
    device = [d for d in device if d[1] > w0 and d[0] < w1
              and "spin_kernel" not in d[2]]

    # busy: the union of the device events' intervals, clipped to the window
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _, _ in sorted(device):
        s, e = max(s, w0), min(e, w1)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))

    # device time of each wrapped entry: what runs between its two marks
    by_corr = {h[4]: h for h in host}
    marks = sorted((h[0], h[1]) for h in host
                   if h[2] == MARK and h[3] == thread)
    mark_starts = [m[0] for m in marks]
    order = sorted(range(len(device)), key=lambda k: device[k][0])
    marked = []             # (host start of the mark's op, device position)
    for pos, k in enumerate(order):
        launch = by_corr.get(device[k][3])
        if launch is None or launch[3] != thread:
            continue
        at = bisect.bisect_right(mark_starts, launch[0]) - 1
        if at >= 0 and marks[at][0] <= launch[0] <= marks[at][1]:
            marked.append((launch[0], pos))
    marked.sort()
    marked_at = [m[0] for m in marked]
    is_mark = {m[1] for m in marked}
    ranges: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    for h in host:
        if h[2].startswith(ENTRY) and h[3] == thread:
            ranges[h[2][len(ENTRY):]].append((h[0], h[1]))
    entry_ns: Dict[str, int] = {}
    for k, rs in ranges.items():
        total = 0
        for r0, r1 in rs:
            lo = bisect.bisect_left(marked_at, r0)
            hi = bisect.bisect_right(marked_at, r1) - 1
            if hi <= lo:
                continue                    # its marks were not both seen
            for pos in range(marked[lo][1] + 1, marked[hi][1]):
                if pos not in is_mark:
                    s, e = device[order[pos]][:2]
                    total += e - s
        entry_ns[k] = total
    # device ops by name
    per_op = collections.Counter()
    for s, e, name, _ in device:
        per_op[name[:NAME_CHARS]] += max(0, min(e, w1) - max(s, w0))
    # idle gaps by the innermost host event open at the gap's middle
    main = sorted((h for h in host if h[3] == thread), key=lambda h: h[0])
    main_starts = [h[0] for h in main]
    per_gap = collections.Counter()
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        at = bisect.bisect_right(main_starts, mid) - 1
        name = "host (no torch op open)"
        for k in range(at, max(-1, at - SCAN), -1):
            if main[k][1] >= mid:
                name = main[k][2]
                break
        per_gap[name[:NAME_CHARS]] += g1 - g0
    return DeviceTrace(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        entry_device_s={k: v / 1e9 for k, v in entry_ns.items()},
        device_ops=[(n, v / 1e9) for n, v in per_op.most_common(TOP)],
        idle_gaps=[(n, v / 1e9) for n, v in per_gap.most_common(TOP)],
        device_events=len(device))
