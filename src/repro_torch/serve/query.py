"""The query-serving engine -- sort/join traffic through one front door.

Counterpart of ``src/repro/serve/query.py``.  ``QueryEngine`` turns the
one-shot ``cluster.sort`` / ``cluster.join`` entry points into a
service.  Callers build :func:`sort_query` / :func:`join_query` specs
-- optionally with a **priority class** and a **deadline** -- and
``submit()`` them (or ``run()`` a whole trace); a dispatcher thread
admits them through a bounded **per-class priority queue**, forms
micro-batches by **continuous batching** (compatible requests join
in-flight buckets the moment they arrive), and executes them over a
shared :class:`~repro_torch.cluster.SubstratePool` on the engine's
device -- the card unless the caller asks for the CPU.

SLO-aware admission, as in the reference: classes are served strictly
best-first (``PRIORITY_HIGH`` before ``PRIORITY_NORMAL`` before
``PRIORITY_LOW``).  When the admission queue is **full**, a submit of
class c evicts the newest queued request of the *worst strictly-lower*
class -- that request is shed with a typed :class:`ShedError` -- and
only blocks (or raises :class:`AdmissionError`) when nothing worse is
queued.  Requests carrying ``deadline_s`` that expire before execution
are shed with :class:`DeadlineExceededError`.  Every shed is surfaced:
``ServeStats.shed`` / ``expired`` / ``shed_by_class``, the
``serve_shed_total{class,reason}`` counters and the per-class
``serve_request_latency_seconds{class}`` histograms, in the engine's
registry and (the shed counters) the process-global ``repro_torch.obs``
registry.

What the engine shares across requests: the plans (the planner's
thread-safe plan cache, so a repeated ``algorithm="auto"`` query skips
its sketch), and the results of identical queries -- duplicates in
flight are **coalesced** (one execution serves every identical request)
and a bounded **result cache** (:class:`ResultCache`, shareable across
engines) serves repeats over time; the algorithms are pure and
explicitly seeded.  The reference also shares compiled programs; the
port compiles nothing (its kernels are built once a process), so the
compile counters of :class:`ServeStats` stay 0.

Where the port differs from the reference, and why:

* **The key.**  The reference hashes each operand's host bytes with
  blake2b; 16 MB of sort keys take longer to hash on the host than the
  sort takes on the card.  The engine instead moves a spec's operands
  to the run's device once (a sort's keys and values; a join's tables
  stay host arrays, as ``cluster.join`` takes them, and are copied
  there for the digest only), keys the spec by the planner's
  :func:`~repro_torch.planner.plan.tensor_digest` of each operand with
  the kind, device, shapes, dtypes and parameters, and hands those
  tensors to the run (so the front door copies nothing again and the
  planner digests the same rows).  A digest is not a cryptographic
  hash, so every hit -- a coalesced twin or a result-cache entry -- is
  confirmed by comparing the operands' bytes with those the leader or
  the entry holds; a digest match that fails the comparison runs as a
  query of its own.  Result-cache entries therefore hold their operands
  (on the card for sorts): :meth:`ResultCache.nbytes` says how much.
* **Results are tensors**, which a requester may edit in place: each
  coalesced twin and each cache hit gets its own clone of the value,
  and the cache keeps a pristine clone of its own.
* **Latency ends when the card is done**: the worker records a CUDA
  event after the run and waits on it (only that worker thread waits),
  so ``exec_s`` and the latency histograms measure the query, not its
  launch.
* ``device=`` takes the place of the reference's ``kernel_backend=``:
  the device decides the kernels.  With ``workers > 1`` several threads
  launch on the card's default stream, where the kernels serialize;
  the engine never forces a sort family (``ops.force_sort_kernel`` is
  process-global).

Every query is executed by the same ``repro_torch.cluster`` code path a
direct call uses; results are bitwise the sequential one-shot calls'.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cluster.api import _x32, resolve_device
from ..cluster.substrate import SubstratePool, recommend_pool_size
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry
from ..planner.plan import fingerprint_arrays, planner_stats

from .batching import ContinuousBatcher, LengthBucketScheduler

__all__ = [
    "AdmissionError", "EngineClosedError", "ShedError",
    "DeadlineExceededError", "ResultTimeout",
    "QuerySpec", "QueryResult", "ServeStats", "QueryEngine",
    "EngineReplicas", "ResultCache",
    "sort_query", "join_query", "run_spec",
    "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_LOW",
    "SERVE_COUNTERS", "reset_serve_counters",
]

# Priority classes: smaller = more important.  Any non-negative int is
# accepted (classes beyond LOW simply sort later); these three are the
# named tiers the metrics label by name.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2
PRIORITY_NAMES = {PRIORITY_HIGH: "high", PRIORITY_NORMAL: "normal",
                  PRIORITY_LOW: "low"}


def _class_name(priority: int) -> str:
    return PRIORITY_NAMES.get(priority, str(priority))


# Module-level serving counters (submitted/admitted/rejected/served/
# failed/shed/expired/coalesced/batches/result_cache_hits): the serve
# twin of ops.DISPATCH_COUNTS.
SERVE_COUNTERS: collections.Counter = collections.Counter()
_COUNTERS_LOCK = threading.Lock()


def _tick(name: str, n: int = 1) -> None:
    with _COUNTERS_LOCK:
        SERVE_COUNTERS[name] += n


def reset_serve_counters() -> None:
    with _COUNTERS_LOCK:
        SERVE_COUNTERS.clear()


class AdmissionError(RuntimeError):
    """The admission queue is full (non-blocking submit) or timed out."""


class ShedError(AdmissionError):
    """Shed under overload: a higher class took this request's slot."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before it could execute."""


class EngineClosedError(RuntimeError):
    """submit() after close()."""


class ResultTimeout(TimeoutError):
    """``ticket.result(timeout)`` expired; carries the ticket's status
    ("queued" / "batched" / "executing" / ...) so a deadline-aware
    caller can decide whether re-submitting is safe (still queued) or
    would duplicate work (already executing)."""

    def __init__(self, query_id: int, timeout: Optional[float],
                 status: str):
        self.query_id = query_id
        self.status = status
        super().__init__(
            f"query {query_id} not served within {timeout}s "
            f"(status: {status})")


# ---------------------------------------------------------------------------
# Query specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One sort/join request: arrays + the cluster front-door parameters.

    ``arrays`` are the positional array operands (sort: ``(x,)`` or
    ``(x, values)``; join: ``(s_keys, s_rows, t_keys, t_rows)``), numpy
    arrays or tensors; ``params`` everything that forwards to
    ``cluster.sort`` / ``cluster.join`` (``device`` among them pins the
    run's device).

    ``priority`` and ``deadline_s`` are *serving* attributes -- they
    shape admission and shedding but not the computation, so they are
    excluded from the key and the compatibility bucket: a high- and a
    low-priority copy of the same query coalesce to one execution.
    """
    kind: str                         # "sort" | "join"
    arrays: Tuple[Any, ...]
    params: Tuple[Tuple[str, Any], ...]   # sorted, hashable
    tag: str = ""                     # caller label, not part of identity
    priority: int = PRIORITY_NORMAL   # class: smaller = more important
    deadline_s: Optional[float] = None  # relative to submit; None = no SLO

    @property
    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    @property
    def size(self) -> int:
        """Total objects across operands -- the micro-batcher's length.

        Metadata only (no copy on the dispatcher path).
        """
        return int(sum(int(np.prod(np.shape(a))) for a in self.arrays))

    def fingerprint(self, device=None) -> str:
        """The engine's key of this spec on ``device`` (None: the card,
        unless the spec pins a device): see :func:`_prepare`."""
        return _prepare(self, _run_device(self, device))[1]

    def bucket_key(self) -> tuple:
        """Compatibility bucket: requests that may share a micro-batch.

        Reads shape/dtype metadata only.
        """
        shapes = tuple((np.shape(a),
                        str(getattr(a, "dtype", type(a).__name__)))
                       for a in self.arrays)
        return (self.kind, self.params, shapes)


def _spec(kind: str, arrays, params: Dict[str, Any], tag: str,
          priority: int, deadline_s: Optional[float]) -> QuerySpec:
    items = tuple(sorted(params.items()))
    try:
        hash(items)
    except TypeError as exc:
        raise TypeError(f"query parameters must be hashable, got {params!r}"
                        ) from exc
    if int(priority) < 0:
        raise ValueError(f"priority must be >= 0, got {priority}")
    if deadline_s is not None and float(deadline_s) < 0:
        raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
    return QuerySpec(kind=kind, arrays=tuple(arrays), params=items, tag=tag,
                     priority=int(priority),
                     deadline_s=None if deadline_s is None
                     else float(deadline_s))


def sort_query(x, *, algorithm: str = "auto", values=None, tag: str = "",
               priority: int = PRIORITY_NORMAL,
               deadline_s: Optional[float] = None, **params) -> QuerySpec:
    """A ``cluster.sort`` request; params forward to the front door."""
    arrays = (x,) if values is None else (x, values)
    params = dict(params, algorithm=algorithm, has_values=values is not None)
    return _spec("sort", arrays, params, tag, priority, deadline_s)


def join_query(s_keys, s_rows, t_keys, t_rows, *, t_machines: int,
               algorithm: str = "auto", tag: str = "",
               priority: int = PRIORITY_NORMAL,
               deadline_s: Optional[float] = None, **params) -> QuerySpec:
    """A ``cluster.join`` request; params forward to the front door."""
    params = dict(params, algorithm=algorithm, t_machines=int(t_machines))
    return _spec("join", (s_keys, s_rows, t_keys, t_rows), params, tag,
                 priority, deadline_s)


def run_spec(spec: QuerySpec, *, substrate=None, device=None):
    """Execute one spec through the cluster front door.

    The single spec-unpacking path: the engine calls it with its shared
    pool and the operands it moved to the device, tests and benchmarks
    call it bare for the sequential one-shot baseline.  ``device`` is
    the run's device unless the spec pins one (None: the card).
    Returns ``(value, report)`` exactly like ``cluster.*``.
    """
    from .. import cluster
    kw = spec.kwargs
    if kw.get("device") is None:
        kw["device"] = device
    if spec.kind == "sort":
        kw.pop("has_values", None)
        values = spec.arrays[1] if len(spec.arrays) > 1 else None
        return cluster.sort(spec.arrays[0], values=values,
                            substrate=substrate, **kw)
    if spec.kind == "join":
        return cluster.join(*spec.arrays, substrate=substrate, **kw)
    raise ValueError(f"unknown query kind {spec.kind!r}")


def _run_device(spec: QuerySpec, device) -> torch.device:
    """The device ``spec`` runs on: its own ``device`` parameter, else
    ``device`` (None: the card)."""
    pinned = spec.kwargs.get("device")
    return resolve_device(device if pinned is None else pinned)


def _device_copy(a, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` as the sort front door narrows it, in memory of
    its own (a later edit of the caller's array cannot reach it)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(dev, copy=True).contiguous()
    a = _x32(a)
    if dev.type == "cpu":
        return torch.from_numpy(np.array(a, order="C"))
    return torch.as_tensor(a).to(dev).contiguous()


def _prepare(spec: QuerySpec, dev: torch.device):
    """``(operands, key)``: the spec's operands as the run takes them,
    private to the engine -- a sort's on ``dev``, a join's tables as
    host arrays -- and the key: the kind, device, parameters and each
    operand's dtype, shape and :func:`tensor_digest` taken on ``dev``.
    """
    if spec.kind == "sort":
        operands = tuple(_device_copy(a, dev) for a in spec.arrays)
        digested = operands
    elif spec.kind == "join":
        operands = tuple(np.array(a, order="C") for a in spec.arrays)
        digested = tuple(torch.from_numpy(a).to(dev) for a in operands)
    else:
        raise ValueError(f"unknown query kind {spec.kind!r}")
    key = fingerprint_arrays(
        *digested,
        extra=f"serve|{spec.kind}|{dev}|n={len(operands)}|{spec.params!r}")
    return operands, key


def _bytes_equal(a, b) -> bool:
    """Whether two operands hold the same bytes (dtype and shape too):
    -0.0 and +0.0, or two NaN payloads, differ here as they do to the
    sort's kernels."""
    if type(a) is not type(b) or a.dtype != b.dtype or a.shape != b.shape:
        return False
    if isinstance(a, torch.Tensor):
        return a.device == b.device and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a.tobytes() == b.tobytes()


def _same_operands(a: Tuple, b: Tuple) -> bool:
    return len(a) == len(b) and all(_bytes_equal(x, y) for x, y in zip(a, b))


def _clone_value(value):
    """A copy of a result value whose tensors are the requester's own."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_clone_value(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_clone_value(v) for v in value)
    return value


def _tensor_bytes(obj, out: Dict[str, int]) -> None:
    """Add the bytes of the tensors and arrays in ``obj`` to ``out``,
    by device type (host arrays under "cpu")."""
    if isinstance(obj, torch.Tensor):
        out[obj.device.type] = (out.get(obj.device.type, 0)
                                + obj.numel() * obj.element_size())
    elif isinstance(obj, np.ndarray):
        out["cpu"] = out.get("cpu", 0) + obj.nbytes
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _tensor_bytes(v, out)


def _copy_report(report):
    """A per-request report copy: shallow + fresh top-level lists.

    Requesters own their report and may decorate or edit it; copying
    the object and its list-valued fields (``phases``,
    ``sketch_phases``) keeps one request's edits invisible to its
    coalesced twins and to the result cache.  Leaf entries (PhaseStats,
    arrays, the QueryPlan) are read-only by convention and stay shared.
    """
    if report is None:
        return None
    dup = copy.copy(report)
    for name, value in list(vars(dup).items()):
        if isinstance(value, list):
            setattr(dup, name, list(value))
    return dup


# ---------------------------------------------------------------------------
# Results + tickets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryResult:
    """Outcome of one request; ``report`` is the per-query AlphaKReport."""
    query_id: int
    spec: QuerySpec
    ok: bool
    value: Any = None                 # (keys, values) / JoinOutput
    report: Any = None                # AlphaKReport (None on failure)
    error: Optional[str] = None
    batch_id: int = -1
    coalesced: bool = False           # served by an identical in-flight twin
    cached: bool = False              # served from the result cache
    latency_s: float = 0.0            # submit -> done (queueing included)
    exec_s: float = 0.0               # the cluster call, to the card's end
    # Per-request timeline, when the engine's tracer is enabled: the
    # root Span of this request's trace.  Coalesced twins share the
    # leader's trace; result-cache hits carry none (nothing executed).
    trace_id: Optional[str] = None
    trace: Any = None

    @property
    def algorithm(self) -> Optional[str]:
        return getattr(self.report, "algorithm", None)

    @property
    def plan_cached(self) -> Optional[bool]:
        plan = getattr(self.report, "query_plan", None)
        return None if plan is None else bool(plan.cached)

    @property
    def capacity_retries(self) -> int:
        return max(0, int(getattr(self.report, "capacity_attempts", 1)) - 1)


class _Ticket:
    """Internal pending-request handle: submit() returns one.

    Lifecycle (``status()``): "queued" (in the admission queue) ->
    "batched" (on the continuous-batching board) -> "executing" ->
    one of "done" / "failed" / "shed" / "expired".
    """

    def __init__(self, query_id: int, spec: QuerySpec, submitted_at: float):
        self.query_id = query_id
        self.spec = spec
        self.submitted_at = submitted_at
        self.priority = max(0, int(getattr(spec, "priority",
                                           PRIORITY_NORMAL)))
        dl = getattr(spec, "deadline_s", None)
        self.deadline_at = None if dl is None else submitted_at + float(dl)
        self._done = threading.Event()
        self._result: Optional[QueryResult] = None
        self._exc: Optional[BaseException] = None
        self._status = "queued"
        self._claimed = False
        self._claim_lock = threading.Lock()

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now > self.deadline_at

    def claim(self) -> bool:
        """Exactly-once finalization guard (first claimer delivers)."""
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def done(self) -> bool:
        return self._done.is_set()

    def status(self) -> str:
        """Where the request is in its lifecycle (racy by nature: a
        'queued' answer may be 'executing' a microsecond later, but a
        terminal answer -- done/failed/shed/expired -- is final)."""
        return self._status

    def result(self, timeout: Optional[float] = None) -> QueryResult:
        if not self._done.wait(timeout):
            raise ResultTimeout(self.query_id, timeout, self._status)
        if self._exc is not None:
            raise self._exc
        return self._result


# ---------------------------------------------------------------------------
# Priority admission: the bounded, class-aware front door queue
# ---------------------------------------------------------------------------

class _AdmissionClosed(Exception):
    """Internal: the admission queue was closed (engine close())."""


class _PriorityAdmission:
    """Bounded multi-class queue: FIFO within a class, strict priority
    across classes, shed-by-class under overload.

    One capacity bound spans all classes.  ``get()`` always serves the
    best (lowest-numbered) nonempty class.  A ``put()`` into a full
    queue evicts the **newest** queued ticket of the **worst strictly
    lower** class and returns it to the caller (who sheds it with a
    typed error); if nothing strictly worse is queued, the put blocks /
    raises ``queue.Full`` -- so a class can never displace itself or a
    better class.

    ``close()`` wakes every blocked producer and consumer: producers
    see :class:`_AdmissionClosed` immediately (their tickets never
    entered, so nothing hangs), consumers drain what remains and then
    see :class:`_AdmissionClosed`.  Closing never blocks, and no engine
    lock is ever held across a blocking queue operation.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._notfull = threading.Condition(self._lock)
        self._classes: Dict[int, collections.deque] = {}
        self._size = 0
        self._closed = False
        self.peak = 0                 # high-water mark of queued tickets

    # ---- state --------------------------------------------------------
    def qsize(self) -> int:
        with self._lock:
            return self._size

    def depths(self) -> Dict[int, int]:
        with self._lock:
            return {c: len(d) for c, d in self._classes.items() if d}

    # ---- producer side ------------------------------------------------
    def _append_locked(self, ticket: _Ticket) -> None:
        self._classes.setdefault(ticket.priority,
                                 collections.deque()).append(ticket)
        self._size += 1
        self.peak = max(self.peak, self._size)
        self._nonempty.notify()

    def _pop_worse_locked(self, priority: int) -> Optional[_Ticket]:
        """Evict the newest ticket of the worst class > ``priority``.

        Newest-of-worst minimizes wasted wait: the evicted request has
        spent the least time queued, and older same-class requests keep
        their FIFO position.
        """
        worst = None
        for cls, dq in self._classes.items():
            if dq and cls > priority and (worst is None or cls > worst):
                worst = cls
        if worst is None:
            return None
        ticket = self._classes[worst].pop()
        self._size -= 1
        return ticket

    def put(self, ticket: _Ticket, block: bool = True,
            timeout: Optional[float] = None) -> Optional[_Ticket]:
        """Admit ``ticket``; returns the shed lower-class ticket if the
        admission evicted one, else None.  Raises ``queue.Full`` when
        full with nothing worse queued (after the block/timeout), and
        :class:`_AdmissionClosed` once closed."""
        with self._lock:
            if self._closed:
                raise _AdmissionClosed
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while self._size >= self.maxsize:
                shed = self._pop_worse_locked(ticket.priority)
                if shed is not None:
                    self._append_locked(ticket)
                    return shed
                if not block:
                    raise queue.Full
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise queue.Full
                if not self._notfull.wait(remaining):
                    raise queue.Full
                if self._closed:
                    raise _AdmissionClosed
            self._append_locked(ticket)
            return None

    # ---- consumer side ------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Optional[_Ticket]:
        """Best class first, FIFO within it.  None on timeout; raises
        :class:`_AdmissionClosed` once closed AND drained (everything
        admitted before close is still delivered)."""
        with self._lock:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while self._size == 0:
                if self._closed:
                    raise _AdmissionClosed
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                if not self._nonempty.wait(remaining):
                    return None
            for cls in sorted(self._classes):
                dq = self._classes[cls]
                if dq:
                    ticket = dq.popleft()
                    self._size -= 1
                    self._notfull.notify()
                    return ticket
            raise AssertionError("size > 0 with all deques empty")

    def drain(self) -> List[_Ticket]:
        """Remove and return everything queued (close-path cleanup)."""
        with self._lock:
            out = [t for cls in sorted(self._classes)
                   for t in self._classes[cls]]
            self._classes.clear()
            self._size = 0
            self._notfull.notify_all()
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
            self._notfull.notify_all()


# ---------------------------------------------------------------------------
# Shared result cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class _Flight:
    """One execution in flight: its operands and the tickets it serves."""
    operands: Tuple[Any, ...]
    tickets: List[_Ticket]


class ResultCache:
    """Bounded content-addressed result LRU, shareable across engines.

    Pure + explicitly-seeded algorithms make equal operands and
    parameters imply an equal result, so serving from the cache is
    exact.  Each entry holds the operands it was computed from, and a
    hit is confirmed against them byte for byte (the key is a digest,
    not a cryptographic hash); a mismatch misses, and the new result
    replaces the entry.  ``EngineReplicas`` passes one instance to
    every replica.
    """

    def __init__(self, size: int = 64):
        self.size = int(size)
        self._lock = threading.Lock()
        # key -> (operands, result)
        self._entries: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()

    def get(self, fp: str, operands: Tuple[Any, ...]
            ) -> Optional[QueryResult]:
        if self.size <= 0:
            return None
        with self._lock:
            entry = self._entries.get(fp)
        if entry is None or not _same_operands(entry[0], operands):
            return None
        with self._lock:
            if fp in self._entries:
                self._entries.move_to_end(fp)
        return entry[1]

    def put(self, fp: str, operands: Tuple[Any, ...],
            entry: QueryResult) -> None:
        if self.size <= 0:
            return
        with self._lock:
            self._entries[fp] = (operands, entry)
            self._entries.move_to_end(fp)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)

    def nbytes(self) -> Dict[str, int]:
        """Bytes the entries hold, operands and values, by device type
        ("cuda" on the card, "cpu" for host memory)."""
        with self._lock:
            entries = list(self._entries.values())
        out: Dict[str, int] = {}
        for operands, result in entries:
            _tensor_bytes(operands, out)
            _tensor_bytes(result.value, out)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# Engine stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeStats:
    """Aggregate serving metrics for one engine (since construction).

    The reference's fields.  Those that count compiled programs --
    ``compiles``, ``program_cache_hits``, ``program_counts`` -- read the
    pool's counters, which stay 0 / empty: the port compiles no
    program, its kernels are built once a process.  ``donation_dropped``
    stays 0 too (no buffer donation).  ``programs_per_query`` is the
    pool's substrate runs per executed query (a sketch round, a
    capacity retry push it above 1).
    """
    served: int = 0                   # results delivered (incl. coalesced)
    executed: int = 0                 # cluster.* calls actually run
    failed: int = 0
    rejected: int = 0                 # backpressure refusals
    shed: int = 0                     # overload evictions (ShedError)
    expired: int = 0                  # deadline sheds (DeadlineExceeded)
    coalesced: int = 0
    result_cache_hits: int = 0
    batches: int = 0
    wall_s: float = 0.0               # first submit -> last completion
    qps: float = 0.0
    p50_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    peak_pending: int = 0             # admission-queue high-water mark
    # Per-class SLO views: {"high": ...} keyed by class name.
    shed_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    served_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    latency_by_class: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)         # class -> {p50, p99, p999}
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    sketch_runs: int = 0
    plan_cache_hit_rate: float = 0.0
    compiles: int = 0
    program_cache_hits: int = 0
    capacity_retries: int = 0
    donation_dropped: int = 0
    program_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    programs_per_query: float = 0.0

    def summary(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, float):
                d[k] = round(v, 6)
        return d


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class QueryEngine:
    """Concurrent sort/join serving over the cluster front door.

    Parameters
    ----------
    max_pending : admission-queue bound (backpressure / shedding beyond
        it -- see the module docstring for the per-class semantics).
    max_batch   : micro-batch size cap.
    batch_window_s : age-out for a cold batching bucket.  Continuous
        batching dispatches full, hot, or engine-idle buckets
        immediately; the window only bounds how long a cold bucket may
        wait for batchmates while the engine is busy.
    workers     : micro-batch executor threads (1 = execute inline in
        the dispatcher).
    pool        : a SubstratePool (or any ``(*axes) -> BatchedSubstrate``
        provider); defaults to a fresh pool.  Passing one engine's pool
        to another shares its substrates and their counters.
    device      : where the queries run unless a spec pins a device;
        None means the card, and raises when there is none.
    tracer      : a :class:`repro_torch.obs.Tracer` for per-request span
        trees; defaults to the process-global tracer (disabled unless
        ``repro_torch.obs.enable()`` was called).
    result_cache_size : result LRU entries (see :class:`ResultCache`).
        0 disables.
    result_cache : a :class:`ResultCache` instance to SHARE (replica
        mode); overrides ``result_cache_size``.
    autostart   : start the dispatcher thread immediately.
    """

    def __init__(self, *, max_pending: int = 256, max_batch: int = 8,
                 batch_window_s: float = 0.002, workers: int = 1,
                 pool: Optional[SubstratePool] = None,
                 device=None,
                 result_cache_size: int = 64,
                 result_cache: Optional[ResultCache] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 autostart: bool = True):
        if max_pending < 1 or max_batch < 1 or workers < 1:
            raise ValueError("max_pending, max_batch and workers must be >= 1")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_s)
        self.pool = pool if pool is not None else SubstratePool()
        self._admit = _PriorityAdmission(int(max_pending))
        self._batcher = ContinuousBatcher(
            max_batch=self.max_batch, window_s=self.batch_window_s,
            scheduler=LengthBucketScheduler(max_batch=self.max_batch))
        self._exec = (ThreadPoolExecutor(max_workers=workers,
                                         thread_name_prefix="serve-worker")
                      if workers > 1 else None)
        self._ids = itertools.count()
        self._batch_ids = itertools.count()
        self._lock = threading.Lock()          # stats below
        self.tracer = tracer if tracer is not None \
            else obs_trace.get_tracer()
        # Engine-local metrics registry: request counters + streaming
        # latency histograms (overall and per class), so a mid-run
        # stats() is O(buckets) however long the engine has served.
        self.metrics = MetricsRegistry()
        self._latency_hist = self.metrics.histogram(
            "serve_request_latency_seconds")
        self._exec_hist = self.metrics.histogram("serve_exec_seconds")
        self._first_submit: Optional[float] = None
        self._last_done: Optional[float] = None
        # key -> the operand sets in flight under it, each with its
        # tickets (several only when different operands share a digest)
        self._inflight: Dict[str, List[_Flight]] = {}
        self._inflight_lock = threading.Lock()
        self.results = result_cache if result_cache is not None \
            else ResultCache(int(result_cache_size))
        self.result_cache_size = self.results.size
        self._planner_base = planner_stats()
        # stats() reports deltas since construction for the pool too
        self._pool_base = (self.pool.stats()
                           if isinstance(self.pool, SubstratePool)
                           else collections.Counter())
        self._closed = False
        # guards ONLY the closed flag's idempotency -- never held across
        # a blocking queue operation
        self._close_lock = threading.Lock()
        self._started = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="serve-dispatcher",
                                            daemon=True)
        if autostart:
            self.start()

    # ---- lifecycle ----------------------------------------------------
    def start(self) -> "QueryEngine":
        if not self._started:
            self._started = True
            self._dispatcher.start()
        return self

    def close(self, wait: bool = True) -> None:
        """Stop admitting; drain and serve everything already admitted.

        Never blocks on the admission queue: closing wakes blocked
        submitters (they raise :class:`EngineClosedError`) and the
        dispatcher, which flushes its buckets and exits.
        """
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._admit.close()
            if not self._started:    # never started: fail queued tickets
                self._drain_failed("engine closed before start()")
                return
        if wait:
            self._dispatcher.join()
            if self._exec is not None:
                self._exec.shutdown(wait=True)
            self._drain_failed("engine closed while the request was "
                               "in the admission queue")

    def __enter__(self) -> "QueryEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- engine-local metric helpers (the registry backs ServeStats) --
    def _count(self, name: str, n: int = 1) -> None:
        self.metrics.counter("serve_events_total", event=name).inc(n)

    def _count_value(self, name: str) -> int:
        return int(self.metrics.counter_value("serve_events_total",
                                              event=name))

    def _drain_failed(self, msg: str) -> None:
        for ticket in self._admit.drain():
            self._finalize(ticket, QueryResult(
                query_id=ticket.query_id, spec=ticket.spec, ok=False,
                error=msg))

    # ---- submission ---------------------------------------------------
    def submit(self, spec: QuerySpec, *, block: bool = True,
               timeout: Optional[float] = None) -> _Ticket:
        """Admit one query.  Returns a ticket; ``ticket.result()`` waits.

        Backpressure + shedding: when the admission queue is full, a
        submit first sheds the newest queued request of a strictly
        lower class (that ticket's ``result()`` raises
        :class:`ShedError`); with nothing worse queued, ``block=True``
        waits (up to ``timeout``) and ``block=False`` raises
        :class:`AdmissionError` immediately.
        """
        if self._closed:
            raise EngineClosedError("submit() on a closed engine")
        _tick("submitted")
        now = time.monotonic()
        ticket = _Ticket(next(self._ids), spec, now)
        try:
            shed = self._admit.put(ticket, block=block, timeout=timeout)
        except queue.Full:
            _tick("rejected")
            self._count("rejected")
            self._shed_metrics(ticket.priority, "rejected")
            raise AdmissionError(
                f"admission queue full ({self._admit.maxsize} pending)")
        except _AdmissionClosed:
            raise EngineClosedError("submit() on a closed engine")
        if shed is not None:
            self._shed(shed, ShedError(
                f"query {shed.query_id} (class "
                f"{_class_name(shed.priority)}) shed under overload for a "
                f"class-{_class_name(ticket.priority)} request"),
                "shed", reason="overload")
        _tick("admitted")
        with self._lock:
            # only an ADMITTED request starts the QPS wall clock
            if self._first_submit is None:
                self._first_submit = now
        return ticket

    def run(self, specs: Sequence[QuerySpec],
            timeout: Optional[float] = None) -> List[QueryResult]:
        """Submit a whole trace and wait for every result (in order)."""
        tickets = [self.submit(s) for s in specs]
        return [t.result(timeout) for t in tickets]

    # ---- dispatch -----------------------------------------------------
    # Board budget, in multiples of max_batch: how many tickets may sit
    # on the batching board (open buckets + released-not-yet-executed
    # groups) at once.  Under overload the excess stays in the bounded
    # admission queue, where class eviction and deadline expiry work.
    _BOARD_BATCHES = 2

    def _dispatch_loop(self) -> None:
        batcher = self._batcher
        futures: List[Tuple[Any, tuple, List[_Ticket]]] = []
        # released-but-not-yet-executed groups, kept best-class-first;
        # one group executes a cycle, so a just-admitted high-priority
        # request waits at most one group execution
        ready: List[Tuple[tuple, List[_Ticket]]] = []
        closed = False
        while True:
            if futures:
                live = []
                for fut, key, group in futures:
                    if fut.done():
                        try:
                            fut.result()
                        except Exception as exc:
                            self._fail_undone(group, exc)
                        batcher.mark_done(key)
                    else:
                        live.append((fut, key, group))
                futures = live
            now = time.monotonic()
            if ready:
                wait = 0.0            # work pending: don't sleep
            else:
                next_due = batcher.next_deadline(now)
                wait = (0.05 if next_due is None
                        else max(0.0, min(next_due - now, 0.05)))
            board = batcher.pending() + sum(len(g) for _, g in ready)
            budget = max(0, self._BOARD_BATCHES * self.max_batch - board)
            drained = 0
            if not closed and budget:
                try:
                    item = self._admit.get(timeout=wait)
                    while item is not None:
                        if self._enqueue(batcher, item):
                            drained += 1   # shed/failed tickets never
                        if drained >= budget:   # reached the board
                            break
                        item = self._admit.get(timeout=0)
                except _AdmissionClosed:
                    closed = True
            elif not ready and (futures or wait > 0):
                # board full (or closed) with nothing executable yet:
                # wait for the next bucket due-time / a worker to finish
                time.sleep(min(wait, 0.002) if wait > 0 else 0.0005)
            now = time.monotonic()
            idle = (not futures and not ready and drained == 0
                    and self._admit.qsize() == 0)
            ready.extend(batcher.release(now, idle=idle, flush=closed))
            ready.sort(key=lambda kg: min(t.priority for t in kg[1]))
            if ready:
                key, group = ready.pop(0)
                group = self._shed_expired(group)
                if group:
                    batcher.mark_dispatched(key, now)
                    if self._exec is not None:
                        futures.append(
                            (self._exec.submit(self._run_batch, group),
                             key, group))
                    else:
                        try:
                            self._run_batch(group)
                        except Exception as exc:
                            # the dispatcher must survive anything a
                            # batch can throw: a dead dispatcher hangs
                            # every pending and future query
                            self._fail_undone(group, exc)
                        batcher.mark_done(key)
            if (closed and not futures and not ready
                    and batcher.pending() == 0):
                return

    def _enqueue(self, batcher: ContinuousBatcher,
                 ticket: _Ticket) -> bool:
        """Move an admitted ticket onto the batching board (or shed it).
        Returns True only when the ticket actually landed on the board
        (sheds don't consume board budget)."""
        now = time.monotonic()
        if ticket.expired(now):
            self._shed(ticket, DeadlineExceededError(
                f"query {ticket.query_id} deadline "
                f"({ticket.spec.deadline_s}s) passed before dispatch"),
                "expired", reason="deadline")
            return False
        try:
            key = ticket.spec.bucket_key()
            size = ticket.spec.size   # _run_batch needs both; a spec
        except Exception as exc:      # whose metadata can't be read must
            self._finalize(ticket, QueryResult(   # fail ITS ticket only
                query_id=ticket.query_id, spec=ticket.spec, ok=False,
                error=f"malformed query spec: {exc!r}"))
            return False
        ticket._status = "batched"
        batcher.add(key, ticket, size, now, ticket.deadline_at)
        return True

    def _shed_expired(self, group: List[_Ticket]) -> List[_Ticket]:
        """Deadline re-check at dispatch: queue+bucket time counts."""
        now = time.monotonic()
        keep = []
        for ticket in group:
            if ticket.expired(now):
                self._shed(ticket, DeadlineExceededError(
                    f"query {ticket.query_id} deadline "
                    f"({ticket.spec.deadline_s}s) passed before execution"),
                    "expired", reason="deadline")
            else:
                keep.append(ticket)
        return keep

    def _fail_undone(self, items: List[_Ticket], exc: Exception) -> None:
        """Backstop for 'impossible' dispatch errors: fail whatever the
        batch left unserved so no ticket blocks forever."""
        for it in items:
            if not it.done():
                self._finalize(it, QueryResult(
                    query_id=it.query_id, spec=it.spec, ok=False,
                    error=f"dispatch failure: {exc!r}"))

    # ---- execution ----------------------------------------------------
    def _run_batch(self, items: List[_Ticket]) -> None:
        if not items:
            return
        batch_id = next(self._batch_ids)
        _tick("batches")
        self._count("batches")
        leaders: List[Tuple[_Ticket, str, _Flight, torch.device]] = []
        for it in items:
            it._status = "executing"
            try:
                dev = _run_device(it.spec, self.device)
                operands, fp = _prepare(it.spec, dev)
            except Exception as exc:   # unreadable operands: fail the
                self._finalize(it, QueryResult(   # ticket, keep serving
                    query_id=it.query_id, spec=it.spec, ok=False,
                    error=f"unfingerprintable query spec: {exc!r}"))
                continue
            # the byte compare waits on the device: make it outside the
            # lock, then join the twin only if it is still in flight
            with self._inflight_lock:
                candidates = list(self._inflight.get(fp, ()))
            twin = next((f for f in candidates
                         if _same_operands(f.operands, operands)), None)
            with self._inflight_lock:
                flights = self._inflight.setdefault(fp, [])
                if twin is not None and any(f is twin for f in flights):
                    twin.tickets.append(it)
                else:
                    flight = _Flight(operands, [it])
                    flights.append(flight)
                    leaders.append((it, fp, flight, dev))
        for leader, fp, flight, dev in leaders:
            cached = self.results.get(fp, flight.operands)
            if cached is not None:
                result = self._from_cache(cached, leader, batch_id)
            else:
                result = self._execute(leader, flight.operands, dev,
                                       batch_id)
                self._cache_put(fp, flight.operands, result)
            with self._inflight_lock:
                flights = self._inflight[fp]
                flights.remove(flight)
                if not flights:
                    del self._inflight[fp]
            # every twin's copy is made before anyone is handed a value:
            # a requester's in-place edit cannot reach another's
            deliveries = [(w, result if w is leader
                           else self._replica(result, w))
                          for w in flight.tickets]
            for w, res in deliveries:
                self._finalize(w, res)

    # ---- result cache (content-addressed; pure algorithms => exact) ---
    def _cache_put(self, fp: str, operands, result: QueryResult) -> None:
        if not result.ok or self.results.size <= 0:
            return
        # a pristine value and report: the requester owns the delivered
        # ones and may edit them -- that must not reach later hits
        self.results.put(fp, operands, dataclasses.replace(
            result, value=_clone_value(result.value),
            report=_copy_report(result.report)))

    def _from_cache(self, cached: QueryResult, it: _Ticket,
                    batch_id: int) -> QueryResult:
        _tick("result_cache_hits")
        self._count("result_cache_hits")
        return dataclasses.replace(
            cached, query_id=it.query_id, spec=it.spec, batch_id=batch_id,
            cached=True, coalesced=False, exec_s=0.0,
            trace_id=None, trace=None,   # a cache hit executed nothing
            value=_clone_value(cached.value),
            report=_copy_report(cached.report))

    def _execute(self, it: _Ticket, operands, dev: torch.device,
                 batch_id: int) -> QueryResult:
        spec = dataclasses.replace(it.spec, arrays=operands)
        t0 = time.monotonic()
        root = None
        # The ROOT span opens here, in the thread that runs the work, so
        # every instrumented layer below attaches to this request's tree
        try:
            with self.tracer.trace("query", kind=spec.kind,
                                   query_id=it.query_id, batch=batch_id,
                                   tag=spec.tag) as root:
                value, report = run_spec(spec, substrate=self.pool,
                                         device=dev)
                if dev.type == "cuda":
                    # the run's last kernels may still be queued: wait
                    # for them here, in this worker only
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    done.synchronize()
            ok, error = True, None
        except Exception as exc:       # isolate failures per query
            value, report, ok, error = None, None, False, repr(exc)
        exec_s = time.monotonic() - t0
        return QueryResult(query_id=it.query_id, spec=it.spec, ok=ok,
                           value=value, report=report, error=error,
                           batch_id=batch_id, exec_s=exec_s,
                           trace_id=root.trace_id if root else None,
                           trace=root)

    def _replica(self, result: QueryResult, w: _Ticket) -> QueryResult:
        """A coalesced twin: its own value clone, identity and report."""
        _tick("coalesced")
        self._count("coalesced")
        return dataclasses.replace(
            result, query_id=w.query_id, spec=w.spec, coalesced=True,
            value=_clone_value(result.value),
            report=_copy_report(result.report))

    # ---- delivery -----------------------------------------------------
    def _shed_metrics(self, priority: int, reason: str) -> None:
        """Tick shed counters in the engine AND global registries."""
        labels = {"class": _class_name(priority), "reason": reason}
        self.metrics.counter("serve_shed_total", **labels).inc()
        obs_metrics.REGISTRY.counter("serve_shed_total", **labels).inc()

    def _shed(self, ticket: _Ticket, exc: Exception, status: str,
              reason: str) -> None:
        """Fail a ticket with a typed shed error: its ``result()``
        raises ``exc`` (never a hung ``_done`` event)."""
        if not ticket.claim():
            return
        now = time.monotonic()
        result = QueryResult(query_id=ticket.query_id, spec=ticket.spec,
                             ok=False, error=repr(exc))
        result.latency_s = now - ticket.submitted_at
        with self._lock:
            self._last_done = now
        _tick(status)
        self._count(status)
        self._shed_metrics(ticket.priority, reason)
        ticket._status = status
        ticket._exc = exc
        ticket._result = result
        ticket._done.set()

    def _finalize(self, it: _Ticket, result: QueryResult) -> None:
        if not it.claim():        # already delivered (e.g. the backstop
            return                # raced a still-running worker)
        done = time.monotonic()
        result.latency_s = done - it.submitted_at
        with self._lock:
            self._last_done = done
        cname = _class_name(it.priority)
        if result.ok:
            self._count("served")
            self.metrics.counter("serve_requests_total",
                                 **{"class": cname,
                                    "outcome": "served"}).inc()
            if not result.coalesced and not result.cached:
                # a real execution (retries only counted once per run)
                self._count("executed")
                self._exec_hist.observe(result.exec_s)
                if result.capacity_retries:
                    self._count("capacity_retries",
                                result.capacity_retries)
            self._latency_hist.observe(result.latency_s)
            self.metrics.histogram("serve_request_latency_seconds",
                                   **{"class": cname}
                                   ).observe(result.latency_s)
            _tick("served")
            it._status = "done"
        else:
            self._count("failed")
            self.metrics.counter("serve_requests_total",
                                 **{"class": cname,
                                    "outcome": "failed"}).inc()
            _tick("failed")
            it._status = "failed"
        it._result = result
        it._done.set()

    # ---- metrics ------------------------------------------------------
    def pending(self) -> int:
        """Requests currently queued for admission (routing signal)."""
        return self._admit.qsize()

    def stats(self) -> ServeStats:
        now = planner_stats()
        delta = {k: now.get(k, 0) - self._planner_base.get(k, 0)
                 for k in set(now) | set(self._planner_base)}
        pool_now = (self.pool.stats() if isinstance(self.pool,
                                                    SubstratePool)
                    else collections.Counter())
        pool_stats = {k: pool_now.get(k, 0) - self._pool_base.get(k, 0)
                      for k in set(pool_now) | set(self._pool_base)}
        with self._lock:
            wall = ((self._last_done - self._first_submit)
                    if self._first_submit is not None
                    and self._last_done is not None else 0.0)
        served = self._count_value("served")
        executed = self._count_value("executed")
        hits = delta.get("cache_hits", 0)
        misses = delta.get("cache_misses", 0)
        shed_by_class: Dict[str, int] = {}
        shed = expired = 0
        for labels, v in self.metrics.counters_matching(
                "serve_shed_total").items():
            lab = dict(labels)
            shed_by_class[lab.get("class", "?")] = \
                shed_by_class.get(lab.get("class", "?"), 0) + int(v)
            if lab.get("reason") == "deadline":
                expired += int(v)
            elif lab.get("reason") == "overload":
                shed += int(v)
        served_by_class = {
            dict(labels).get("class", "?"): int(v)
            for labels, v in self.metrics.counters_matching(
                "serve_requests_total").items()
            if dict(labels).get("outcome") == "served"}
        latency_by_class = {
            dict(labels).get("class", "?"): {
                "p50": hist.quantile(0.50), "p99": hist.quantile(0.99),
                "p999": hist.quantile(0.999)}
            for labels, hist in self.metrics.histograms_matching(
                "serve_request_latency_seconds").items()
            if labels}   # the unlabeled histogram is the overall one
        return ServeStats(
            served=served,
            executed=executed,
            failed=self._count_value("failed"),
            rejected=self._count_value("rejected"),
            shed=shed,
            expired=expired,
            coalesced=self._count_value("coalesced"),
            result_cache_hits=self._count_value("result_cache_hits"),
            batches=self._count_value("batches"),
            wall_s=wall,
            qps=served / wall if wall > 0 else 0.0,
            p50_latency_s=self._latency_hist.quantile(0.50),
            p99_latency_s=self._latency_hist.quantile(0.99),
            peak_pending=self._admit.peak,
            shed_by_class=shed_by_class,
            served_by_class=served_by_class,
            latency_by_class=latency_by_class,
            plan_cache_hits=hits,
            plan_cache_misses=misses,
            sketch_runs=delta.get("sketch_runs", 0),
            plan_cache_hit_rate=(hits / (hits + misses)
                                 if hits + misses else 0.0),
            compiles=pool_stats.get("compiles", 0),
            program_cache_hits=pool_stats.get("program_cache_hits", 0),
            capacity_retries=self._count_value("capacity_retries"),
            donation_dropped=pool_stats.get("donation_dropped", 0),
            program_counts={k[len("compiles["):-1]: v
                            for k, v in sorted(pool_stats.items())
                            if k.startswith("compiles[") and v},
            programs_per_query=(pool_stats.get("runs", 0) / executed
                                if executed else 0.0),
        )


# ---------------------------------------------------------------------------
# Engine replicas: one front door, N engines, shared caches
# ---------------------------------------------------------------------------

class EngineReplicas:
    """N :class:`QueryEngine` replicas behind one front door.

    All replicas share ONE :class:`~repro_torch.cluster.SubstratePool`
    and ONE :class:`ResultCache`; the plan cache is process-global and
    thread-safe, each run's tape is its own, and cached results are
    confirmed against their operands, so a cross-replica hit is the
    same answer.  In-flight coalescing stays per replica: identical
    queries racing on two replicas may execute twice, which costs work
    but never changes an answer.

    Routing: least-pending replica, round-robin among ties; a
    non-blocking submit that one replica refuses is offered to the
    others before :class:`AdmissionError` propagates.
    ``suggest_replicas()`` feeds the measured arrival rate and
    execution time into :func:`recommend_pool_size`.
    """

    def __init__(self, replicas: int = 2, *,
                 pool: Optional[SubstratePool] = None,
                 result_cache_size: int = 64,
                 **engine_kw):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        engine_kw.pop("result_cache", None)
        self.pool = pool if pool is not None else SubstratePool()
        self.results = ResultCache(int(result_cache_size))
        self.engines = [QueryEngine(pool=self.pool,
                                    result_cache=self.results,
                                    **engine_kw)
                        for _ in range(replicas)]
        self._rr = itertools.count()

    # ---- lifecycle ----------------------------------------------------
    def __enter__(self) -> "EngineReplicas":
        for e in self.engines:
            e.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, wait: bool = True) -> None:
        for e in self.engines:
            e.close(wait=wait)

    # ---- traffic ------------------------------------------------------
    def submit(self, spec: QuerySpec, *, block: bool = True,
               timeout: Optional[float] = None) -> _Ticket:
        n = len(self.engines)
        start = next(self._rr) % n
        order = sorted(range(n),
                       key=lambda i: (self.engines[i].pending(),
                                      (i - start) % n))
        last: Optional[Exception] = None
        for i in order:
            try:
                return self.engines[i].submit(spec, block=block,
                                              timeout=timeout)
            except AdmissionError as exc:
                last = exc            # full here; try a sibling first
        raise last if last is not None else AdmissionError("no replicas")

    def run(self, specs: Sequence[QuerySpec],
            timeout: Optional[float] = None) -> List[QueryResult]:
        tickets = [self.submit(s) for s in specs]
        return [t.result(timeout) for t in tickets]

    # ---- metrics ------------------------------------------------------
    def replica_stats(self) -> List[ServeStats]:
        return [e.stats() for e in self.engines]

    def stats(self) -> ServeStats:
        """Fleet view: counts summed, percentiles worst-of-replicas
        (a fleet meets an SLO only if every replica does)."""
        per = self.replica_stats()
        agg = ServeStats()
        for s in per:
            for f in ("served", "executed", "failed", "rejected", "shed",
                      "expired", "coalesced", "result_cache_hits",
                      "batches", "plan_cache_hits", "plan_cache_misses",
                      "sketch_runs", "capacity_retries",
                      "program_cache_hits"):
                setattr(agg, f, getattr(agg, f) + getattr(s, f))
            for cls, v in s.shed_by_class.items():
                agg.shed_by_class[cls] = agg.shed_by_class.get(cls, 0) + v
            for cls, v in s.served_by_class.items():
                agg.served_by_class[cls] = \
                    agg.served_by_class.get(cls, 0) + v
            agg.wall_s = max(agg.wall_s, s.wall_s)
            agg.peak_pending = max(agg.peak_pending, s.peak_pending)
            agg.p50_latency_s = max(agg.p50_latency_s, s.p50_latency_s)
            agg.p99_latency_s = max(agg.p99_latency_s, s.p99_latency_s)
        # the pool is shared: count its compiles once, not per replica
        agg.compiles = per[0].compiles if per else 0
        agg.donation_dropped = per[0].donation_dropped if per else 0
        agg.qps = agg.served / agg.wall_s if agg.wall_s > 0 else 0.0
        hm = agg.plan_cache_hits + agg.plan_cache_misses
        agg.plan_cache_hit_rate = agg.plan_cache_hits / hm if hm else 0.0
        return agg

    def suggest_replicas(self, *, target_utilization: float = 0.7,
                         max_replicas: int = 64) -> int:
        """QPS-derived sizing from observed traffic (Little's law)."""
        agg = self.stats()
        service = max(e.metrics.histogram("serve_exec_seconds").mean
                      for e in self.engines)
        return recommend_pool_size(agg.qps, service,
                                   target_utilization=target_utilization,
                                   max_replicas=max_replicas)
