"""Execution substrate of the port: t machines as a batch axis.

Counterpart of ``src/repro/cluster/substrate.py``.  The reference runs
a per-device body under ``vmap`` (``VmapSubstrate``, :201) or
``shard_map``; the port's bodies are written batched over the machines
already, so :class:`BatchedSubstrate` hands the body the machine-major
tensors and a fresh :class:`CollectiveTape` and returns both.  Axes are
declared as the reference declares them, ``(name, size)`` pairs or bare
sizes; the machines are the product of the sizes, every tensor's
leading axis, machine-major.

:class:`SubstratePool` is the reference's thread-safe cache of
substrates keyed by their normalized axes (``(t,)`` for the sorts and
the 1D joins, ``(("a", a), ("b", b))`` for RandJoin's machine matrix,
the staged grid's two named axes); the front door's ``substrate=``
takes a substrate, such a provider, or None -- the process-wide
:func:`default_pool`.  The reference's pool shares compiled programs;
the port compiles nothing (its kernels are built once a process), so
what a pool shares here is the substrate objects and their run
counters (runs, not compiles: ``ServeStats``' compile fields read 0).

Under an open trace each run is a ``substrate.run`` span whose
``phase:<name>`` children carry the tape's per-phase sent/received
counts, the same numbers the AlphaKReport's phases hold (the
reference's ``_attach_phases``, ``src/repro/cluster/substrate.py:168``).
With no trace open the tape's device counters are not read.
"""
from __future__ import annotations

import collections
import functools
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

from ..obs import trace as obs_trace
from .collectives import CollectiveTape

__all__ = ["BatchedSubstrate", "SubstratePool", "default_pool",
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


class BatchedSubstrate:
    """t machines on one device, each tensor's leading axis the machine.

    ``stats`` counts ``runs`` (and ``runs[<body>]``); several threads
    may run on one substrate at once, since a run's only state is its
    own tape, so the lock guards the counters alone.
    """

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

    def run(self, shard_fn: Callable, *args):
        """Run ``shard_fn(*args, tape=tape)``; return ``(outputs, tape)``.

        Every argument carries the machine axis first (``(t, m)``).
        """
        for a in args:
            if a.shape[0] != self.t:
                raise ValueError(f"operand with leading dim {a.shape[0]} on "
                                 f"a {self.t}-machine substrate")
        label = _fn_label(shard_fn)
        with self._lock:
            self.stats["runs"] += 1
            self.stats[f"runs[{label}]"] += 1
        with obs_trace.span("substrate.run", body=label,
                            substrate=type(self).__name__, t=self.t) as sp:
            tape = CollectiveTape()
            out = shard_fn(*args, tape=tape)
            if sp is not None:
                for ph in tape.phases(self.t):
                    sp.add_child(f"phase:{ph.name}", sent=ph.sent,
                                 received=ph.received)
            return out, tape

    def __repr__(self) -> str:
        axes = ",".join(f"{n}={s}" for n, s in self.axes)
        return f"BatchedSubstrate({axes})"


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
    agrees on the axes shares one substrate and its counters.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict = {}

    def __call__(self, *axes: AxisSpec) -> BatchedSubstrate:
        key = _normalize_axes(axes)
        with self._lock:
            sub = self._subs.get(key)
            if sub is None:
                sub = self._subs[key] = BatchedSubstrate(*key)
            return sub

    def substrates(self) -> Tuple[BatchedSubstrate, ...]:
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


def resolve_substrate(substrate, *axes: AxisSpec) -> BatchedSubstrate:
    """A substrate for ``axes`` from what the caller passed.

    ``substrate`` is a :class:`BatchedSubstrate` (returned as it is), a
    provider -- any callable mapping an axis spec to one, a
    :class:`SubstratePool` above all -- or None, the process-wide
    :func:`default_pool`.  The reference's ``api._resolve_substrate``.
    """
    if substrate is None:
        substrate = default_pool()
    if isinstance(substrate, BatchedSubstrate):
        return substrate
    if callable(substrate):
        sub = substrate(*axes)
        if not isinstance(sub, BatchedSubstrate):
            raise TypeError(f"substrate provider {substrate!r} returned "
                            f"{type(sub).__name__}, expected a "
                            f"BatchedSubstrate")
        return sub
    raise TypeError(f"substrate must be a BatchedSubstrate, a provider "
                    f"callable, or None, got {type(substrate).__name__}")


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
