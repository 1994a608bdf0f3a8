"""Execution substrate of the port: t machines as a batch axis.

Counterpart of ``src/repro/cluster/substrate.py``.  The reference runs
a per-device body under ``vmap`` (``VmapSubstrate``, :201) or
``shard_map``; the port's bodies are written batched over the machines
already, so :class:`BatchedSubstrate` hands the body the machine-major
tensors and a fresh :class:`CollectiveTape` and returns both.  There is
no compiled program to cache, so :func:`default_pool` -- what the front
door resolves ``substrate=None`` to -- makes a substrate per call.

Under an open trace each run is a ``substrate.run`` span whose
``phase:<name>`` children carry the tape's per-phase sent/received
counts, the same numbers the AlphaKReport's phases hold (the
reference's ``_attach_phases``, ``src/repro/cluster/substrate.py:168``).
With no trace open the tape's device counters are not read.
"""
from __future__ import annotations

import functools
from typing import Callable

from ..obs import trace as obs_trace
from .collectives import CollectiveTape

__all__ = ["BatchedSubstrate", "default_pool"]


class BatchedSubstrate:
    """t machines on one device, each tensor's leading axis the machine."""

    def __init__(self, t: int):
        if t < 1:
            raise ValueError(f"substrate needs t >= 1 machines, got {t}")
        self.t = int(t)

    def run(self, shard_fn: Callable, *args):
        """Run ``shard_fn(*args, tape=tape)``; return ``(outputs, tape)``.

        Every argument carries the machine axis first (``(t, m)``).
        """
        for a in args:
            if a.shape[0] != self.t:
                raise ValueError(f"operand with leading dim {a.shape[0]} on "
                                 f"a {self.t}-machine substrate")
        with obs_trace.span("substrate.run", body=_fn_label(shard_fn),
                            substrate=type(self).__name__, t=self.t) as sp:
            tape = CollectiveTape()
            out = shard_fn(*args, tape=tape)
            if sp is not None:
                for ph in tape.phases(self.t):
                    sp.add_child(f"phase:{ph.name}", sent=ph.sent,
                                 received=ph.received)
            return out, tape

    def __repr__(self) -> str:
        return f"BatchedSubstrate(t={self.t})"


def _fn_label(fn: Callable) -> str:
    """The body's name, for the span (``smms_shard``, ...)."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "__name__", type(fn).__name__).lstrip("_")


def default_pool() -> Callable[[int], BatchedSubstrate]:
    """The provider behind ``substrate=None``: t -> a BatchedSubstrate."""
    return BatchedSubstrate
