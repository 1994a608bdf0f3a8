"""Execution substrates of the port: one ``run(shard_fn, *args)`` API,
two executors.

Counterpart of ``src/repro/cluster/substrate.py``.  The reference runs
a per-device body under ``vmap`` (``VmapSubstrate``, :201) or
``shard_map`` (``ShardMapSubstrate``, :266); the port's bodies are
written batched over the machines they hold, so

* :class:`BatchedSubstrate` holds all t machines on one device: it
  hands the body the machine-major tensors and a fresh
  :class:`CollectiveTape`, and every collective is a tensor operation;
* :class:`ProcessGroupSubstrate` spreads them over the ranks of a
  ``torch.distributed`` group: each rank's body gets its t / world
  rows and a :class:`ProcessGroupTape`, whose collectives go to the
  other ranks; every rank gets the whole outputs and report back.

Both return ``(outputs, tape)``, bitwise alike on one device type.
Axes are declared as the reference declares them, ``(name, size)``
pairs or bare sizes; the machines are the product of the sizes, every
tensor's leading axis, machine-major.

:class:`SubstratePool` is the reference's thread-safe cache of
substrates keyed by their normalized axes (``(t,)`` for the sorts and
the 1D joins, ``(("a", a), ("b", b))`` for RandJoin's machine matrix,
the staged grid's two named axes), built by its ``make``; the front
door's ``substrate=`` takes a substrate, such a provider, or None --
the process-wide :func:`default_pool`.  The reference's pool shares
compiled programs; the port compiles nothing (its kernels are built
once a process), so what a pool shares here is the substrate objects
and their run counters (runs, not compiles: ``ServeStats``' compile
fields read 0).

Under an open trace each run is a ``substrate.run`` span whose
``phase:<name>`` descendants, opened live by the tape's phases, carry
the tape's per-phase sent/received counts once the run is over, the
same numbers the AlphaKReport's phases hold (the reference's
``_attach_phases``, ``src/repro/cluster/substrate.py:168``).
With no trace open a batch's device counters are not read; a process
group's are gathered after every run (a collective every rank takes,
trace or not), and a span reads those.
"""
from __future__ import annotations

import collections
import functools
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..obs import trace as obs_trace
from .collectives import CollectiveTape, ProcessGroupTape

__all__ = ["Substrate", "BatchedSubstrate", "ProcessGroupSubstrate",
           "SubstratePool", "default_pool", "default_substrate",
           "reset_default_pool", "recommend_pool_size", "resolve_substrate"]

AxisSpec = Union[int, Tuple[str, int]]

_DEFAULT_NAMES = ("i", "j", "k")


def _normalize_axes(axes: Sequence[AxisSpec]) -> Tuple[Tuple[str, int], ...]:
    out = []
    for pos, ax in enumerate(axes):
        if isinstance(ax, int):
            out.append((_DEFAULT_NAMES[pos], ax))
        else:
            name, size = ax
            out.append((str(name), int(size)))
    return tuple(out)


class Substrate:
    """What both substrates share: the axes, ``shape``, ``t``, and the
    run counters (``runs``, ``runs[<body>]``) under a lock.  The
    reference's ``Substrate`` (``src/repro/cluster/substrate.py:107``)."""

    def __init__(self, *axes: AxisSpec):
        if not axes:
            raise ValueError("substrate needs at least one axis")
        self.axes = _normalize_axes(axes)
        if any(s < 1 for _, s in self.axes):
            raise ValueError(f"substrate needs t >= 1 machines, got "
                             f"{self.shape}")
        self.t = math.prod(self.shape)
        self._lock = threading.Lock()
        self.stats: collections.Counter = collections.Counter()

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    def stats_snapshot(self) -> Dict[str, int]:
        """A copy of the run counters, taken under their lock.  There is
        no ``compiles`` count to copy: the port compiles no program."""
        with self._lock:
            return dict(self.stats)

    def _count_run(self, shard_fn: Callable, args) -> str:
        """Check the operands' machine axis, count the run; returns the
        body's label."""
        for a in args:
            if a.shape[0] != self.t:
                raise ValueError(f"operand with leading dim {a.shape[0]} on "
                                 f"a {self.t}-machine substrate")
        label = _fn_label(shard_fn)
        with self._lock:
            self.stats["runs"] += 1
            self.stats[f"runs[{label}]"] += 1
        return label

    def run(self, shard_fn: Callable, *args):
        """Run ``shard_fn(*args, tape=tape)`` on every machine; return
        ``(outputs, tape)``."""
        raise NotImplementedError

    def __repr__(self) -> str:
        axes = ",".join(f"{n}={s}" for n, s in self.axes)
        return f"{type(self).__name__}({axes})"


class BatchedSubstrate(Substrate):
    """t machines on one device, each tensor's leading axis the machine.

    ``stats`` counts ``runs`` (and ``runs[<body>]``); several threads
    may run on one substrate at once, since a run's only state is its
    own tape, so the lock guards the counters alone.
    """

    def run(self, shard_fn: Callable, *args):
        """Run ``shard_fn(*args, tape=tape)``; return ``(outputs, tape)``.

        Every argument carries the machine axis first (``(t, m)``).
        """
        label = self._count_run(shard_fn, args)
        with obs_trace.span("substrate.run", body=label,
                            substrate=type(self).__name__, t=self.t) as sp:
            tape = CollectiveTape()
            out = shard_fn(*args, tape=tape)
            _attach_phases(sp, tape, self.t)
            return out, tape


class ProcessGroupSubstrate(Substrate):
    """The t machines spread over the ranks of a ``torch.distributed``
    process group, one device a rank: the reference's
    ``ShardMapSubstrate`` (``src/repro/cluster/substrate.py:266``).

    ``group=None`` is the default group, which the caller initialises
    (``dist.init_process_group(backend, init_method=..., world_size=...,
    rank=..., timeout=...)``; the timeout bounds every wait).  Rank r of
    a world of w holds machines ``[r*t_loc, (r+1)*t_loc)``, t_loc =
    t / w, as a batch: the bodies of ``core/`` run on those rows, and
    every collective between machines goes through a
    :class:`~repro_torch.cluster.collectives.ProcessGroupTape` to the
    other ranks.  t must be a multiple of w.

    ``run(shard_fn, *args)`` takes the whole machine-major operands on
    every rank, as the reference's single controller passes global
    arrays, and hands the body its rank's rows.  It returns on every
    rank what ``BatchedSubstrate.run`` returns for those operands:
    after the body, outside the tape's phases, each output tensor is
    gathered along the machine axis -- except those the body marked
    with ``tape.replicated`` (the psum'd ``dropped``, the (t+1,)
    boundaries), which every rank holds whole already; an unmarked
    0-dim output raises.  Then the tape reads every rank's records in
    one gather, so every rank builds the same whole report, whether a
    trace is open or not.

    A Gloo group's collectives of CUDA operands stage through pinned
    host memory (``ProcessGroupTape``); ``stats["host_staged_runs"]``
    counts the runs that did.

    Every rank must make the same runs in the same order.  Runs on
    process-group substrates are serialized within a process (one lock
    for all of them), so the threads of a query engine keep each rank's
    collectives in one order.  A query engine's coalescing and result
    cache decide on each rank alone, so an engine serves over a group
    of one rank (the tests' and chip_smoke.py's); with more ranks every
    rank would have to skip the same runs.
    """

    def __init__(self, *axes: AxisSpec, group=None):
        super().__init__(*axes)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ProcessGroupSubstrate needs an initialised process group: "
                "call torch.distributed.init_process_group first")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.t % self.world:
            raise ValueError(f"{self.t} machines do not spread evenly over "
                             f"a group of {self.world} ranks")
        self.t_loc = self.t // self.world

    def run(self, shard_fn: Callable, *args):
        label = self._count_run(shard_fn, args)
        lo = self.rank * self.t_loc
        with _GROUP_RUN_LOCK, obs_trace.span(
                "substrate.run", body=label, substrate=type(self).__name__,
                t=self.t, rank=self.rank, world=self.world) as sp:
            tape = ProcessGroupTape(self.group, self.t)
            out = shard_fn(*(a[lo:lo + self.t_loc] for a in args), tape=tape)
            out = _gather_outputs(out, tape)
            tape.bind()
            if tape.host_staged:
                with self._lock:
                    self.stats["host_staged_runs"] += 1
            _attach_phases(sp, tape, self.t)
            return out, tape


_GROUP_RUN_LOCK = threading.RLock()


def _gather_outputs(out, tape: ProcessGroupTape):
    """The body's outputs, whole: each tensor gathered along the machine
    axis unless marked replicated; tuples (named or not) element by
    element; anything else as it is."""
    if isinstance(out, torch.Tensor):
        if tape.is_replicated(out):
            return out
        if out.dim() == 0:
            raise ValueError("a body returned a 0-dim tensor not marked with "
                             "tape.replicated: it has no machine axis")
        return tape._whole(out)
    if isinstance(out, tuple):
        parts = [_gather_outputs(o, tape) for o in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return out


def _attach_phases(sp, tape: CollectiveTape, t: int) -> None:
    """Under an open trace, the tape's per-phase counts on the live
    ``phase:<name>`` spans the run opened (a phase with none -- records
    taped outside every phase -- becomes an instant child of the run's
    span); no trace: the counters are not read."""
    if sp is None:
        return
    for ph in tape.phases(t):
        live = tape.phase_spans.get(ph.name)
        if live is None:
            sp.add_child(f"phase:{ph.name}", sent=ph.sent,
                         received=ph.received)
        else:
            live.attrs.update(sent=ph.sent, received=ph.received)


def _fn_label(fn: Callable) -> str:
    """The body's name, for the span (``smms_shard``, ...)."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "__name__", type(fn).__name__).lstrip("_")


class SubstratePool:
    """Thread-safe cache of substrates keyed by their (normalized) axes.

    Anywhere the front door takes ``substrate=``, a pool may be passed
    instead: ``cluster.sort`` / ``cluster.join`` and the core wrappers
    call it with the axes each algorithm needs, and every query that
    agrees on the axes shares one substrate and its counters.  ``make``
    builds a substrate from the axes (``lambda *axes:
    ProcessGroupSubstrate(*axes)`` serves over a process group, as the
    reference's pools of ``ShardMapSubstrate`` do); the default is a
    :class:`BatchedSubstrate`.
    """

    def __init__(self, make: Optional[Callable[..., Substrate]] = None):
        self._make = make if make is not None else BatchedSubstrate
        self._lock = threading.Lock()
        self._subs: dict = {}

    def __call__(self, *axes: AxisSpec) -> Substrate:
        key = _normalize_axes(axes)
        with self._lock:
            sub = self._subs.get(key)
            if sub is None:
                sub = self._subs[key] = self._make(*key)
            return sub

    def substrates(self) -> Tuple[Substrate, ...]:
        with self._lock:
            return tuple(self._subs.values())

    def stats(self) -> collections.Counter:
        """Run counters summed over the pool's substrates."""
        total: collections.Counter = collections.Counter()
        for sub in self.substrates():
            total.update(sub.stats_snapshot())
        return total


_DEFAULT_POOL: Optional[SubstratePool] = None
_DEFAULT_POOL_LOCK = threading.Lock()


def default_pool() -> SubstratePool:
    """The process-wide SubstratePool behind ``substrate=None``."""
    global _DEFAULT_POOL
    with _DEFAULT_POOL_LOCK:
        if _DEFAULT_POOL is None:
            _DEFAULT_POOL = SubstratePool()
        return _DEFAULT_POOL


def reset_default_pool() -> None:
    """Drop the shared pool (and with it its run counters)."""
    global _DEFAULT_POOL
    with _DEFAULT_POOL_LOCK:
        _DEFAULT_POOL = None


def resolve_substrate(substrate, *axes: AxisSpec) -> Substrate:
    """A substrate for ``axes`` from what the caller passed.

    ``substrate`` is a :class:`Substrate` (returned as it is), a
    provider -- any callable mapping an axis spec to one, a
    :class:`SubstratePool` above all -- or None, the process-wide
    :func:`default_pool`.  The reference's ``api._resolve_substrate``.
    """
    if substrate is None:
        substrate = default_pool()
    if isinstance(substrate, Substrate):
        return substrate
    if callable(substrate):
        sub = substrate(*axes)
        if not isinstance(sub, Substrate):
            raise TypeError(f"substrate provider {substrate!r} returned "
                            f"{type(sub).__name__}, expected a Substrate "
                            f"(a BatchedSubstrate or a ProcessGroupSubstrate)")
        return sub
    raise TypeError(f"substrate must be a Substrate (a BatchedSubstrate or a "
                    f"ProcessGroupSubstrate), a provider callable, or None, "
                    f"got {type(substrate).__name__}")


def default_substrate(*axes: AxisSpec, prefer_mesh: bool = False
                      ) -> Substrate:
    """An executor for ``axes``: with ``prefer_mesh``, a
    :class:`ProcessGroupSubstrate` when a process group is initialised
    and its size divides the machines; else a :class:`BatchedSubstrate`
    (the reference's ``default_substrate``, whose mesh needs a device a
    machine)."""
    sub = BatchedSubstrate(*axes)
    if (prefer_mesh and dist.is_available() and dist.is_initialized()
            and sub.t % dist.get_world_size() == 0):
        return ProcessGroupSubstrate(*axes)
    return sub


def recommend_pool_size(qps: float, service_time_s: float, *,
                        target_utilization: float = 0.7,
                        max_replicas: int = 64) -> int:
    """Replica count for an observed load, by Little's law.

    A replica serving one request at a time sustains
    ``1 / service_time_s`` QPS at full utilization; running fleets at
    ``target_utilization`` (default 0.7) leaves headroom so queueing
    delay stays bounded under arrival bursts.  So:

        replicas = ceil(qps * service_time_s / target_utilization)

    clamped to ``[1, max_replicas]``.  This is the QPS-derived sizing
    hook behind ``EngineReplicas.suggest_replicas()``.  Non-positive qps
    or service time mean "no observed load": returns 1.
    """
    if not 0.0 < target_utilization <= 1.0:
        raise ValueError(
            f"target_utilization must be in (0, 1], got {target_utilization}")
    if max_replicas < 1:
        raise ValueError(f"max_replicas must be >= 1, got {max_replicas}")
    if qps <= 0 or service_time_s <= 0:
        return 1
    # round at 9 digits before ceil: 100*0.07/0.7 is 10.000000000000002
    # in binary and must size as 10 replicas, not 11
    need = math.ceil(round(qps * service_time_s / target_utilization, 9))
    return max(1, min(int(max_replicas), int(need)))
