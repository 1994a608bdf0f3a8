"""Chrome-trace (Perfetto-loadable) JSON export for span trees.

A copy of ``src/repro/obs/export.py`` (pure Python; the port imports
nothing of the reference package).

``chrome_trace(spans)`` renders finished root spans into the Trace
Event Format that ``chrome://tracing`` and https://ui.perfetto.dev
consume directly:

* every :class:`~repro_torch.obs.trace.Span` with nonzero duration becomes a
  ``"ph": "X"`` *complete* event (``ts``/``dur`` in microseconds);
* zero-duration spans (the post-hoc phase spans) and span events become
  ``"ph": "i"`` *instant* events so taped-bytes annotations still show
  on the timeline;
* numpy and tensor attribute values are converted to plain
  lists/scalars in ``args`` (the trace viewer only speaks JSON).

Each trace gets its own ``pid`` row (derived from the trace id) so
concurrent requests render as parallel tracks; nesting within a trace
comes from Chrome's stacking of overlapping complete events on one
``tid``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Union

from .trace import Span

__all__ = ["chrome_trace", "write_chrome_trace"]


def _jsonable(v: Any) -> Any:
    """Best-effort conversion of attr values to JSON-safe types."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "tolist"):  # numpy arrays / scalars, tensors
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def _pid(trace_id: str) -> int:
    # Stable small int per trace so each request gets its own track.
    return sum(ord(c) for c in trace_id) % 10_000 + 1


def chrome_trace(spans: Union[Span, Iterable[Span]]) -> Dict[str, Any]:
    """Render root span(s) to a Trace Event Format document."""
    roots = [spans] if isinstance(spans, Span) else list(spans)
    events: List[Dict[str, Any]] = []
    for root in roots:
        pid = _pid(root.trace_id)
        events.append({"ph": "M", "pid": pid, "tid": 1,
                       "name": "process_name",
                       "args": {"name": f"trace {root.trace_id}"}})
        for sp in root.walk():
            ts = sp.start_s * 1e6
            dur = sp.duration_s * 1e6
            args = {k: _jsonable(v) for k, v in sp.attrs.items()}
            args["span_id"] = sp.span_id
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            if dur > 0:
                events.append({"ph": "X", "pid": pid, "tid": 1,
                               "name": sp.name, "cat": "span",
                               "ts": ts, "dur": dur, "args": args})
            else:
                events.append({"ph": "i", "pid": pid, "tid": 1,
                               "name": sp.name, "cat": "span", "ts": ts,
                               "s": "t", "args": args})
            for ev in sp.events:
                events.append({"ph": "i", "pid": pid, "tid": 1,
                               "name": f"{sp.name}@{ev.name}",
                               "cat": "event", "ts": ev.ts_s * 1e6,
                               "s": "t",
                               "args": {k: _jsonable(v)
                                        for k, v in ev.attrs.items()}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       spans: Union[Span, Iterable[Span]]) -> str:
    """Dump ``chrome_trace(spans)`` to ``path``; returns the path."""
    doc = chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path
