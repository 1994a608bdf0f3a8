"""Instrumented collectives -- the (alpha, k) accounting layer.

Counterpart of ``src/repro/cluster/collectives.py`` (``CollectiveTape``).
torch has no named-axis collectives, so the port writes every body
batched over the t machines: each tensor carries the machine axis
first, and a collective is a tensor operation on that axis.

* ``all_gather``  -- every machine receives the same (t, c) array, which
  is the machine-major operand itself: the broadcast is free and the
  result is shared.  sent = c per machine (or the caller's ``count``),
  received = the sum of what was sent.
* ``all_to_all``  -- the (t_src, t_dst, C) send tiles become the
  (t_dst, t_src, C) landed tiles: a transpose of the first two axes.
  sent is the caller's off-machine count; received counts the landed
  slots below ``pad`` (sentinel-aware), per machine.

Either takes ``track=False`` for a payload that rides along an
exchange already counted (the paper counts objects: a key and its
payload are one object).
* ``psum``        -- a sum over the machine axis; O(1) control scalars
  are not counted.

Phases are declared with ``tape.phase(name)``; alpha is the number of
declared phases, and a phase with no traffic still counts.  Counts are
recorded as (t,) float32 tensors, as the reference records float32
scalars per device, and read back to the host once, in :meth:`phases`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

# repro_torch.core.alpha_k is imported inside phases()/report(): the
# core modules import this one at load time.

__all__ = ["CollectiveTape"]


class CollectiveTape:
    """Records per-machine collective traffic of one batched execution."""

    def __init__(self) -> None:
        self._phase_order: List[str] = []
        self._entry_phase: List[str] = []
        self._entries: List = []             # (sent, received) per record
        self._current: Optional[str] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        """Declare a synchronized round; records inside merge into it."""
        if name not in self._phase_order:
            self._phase_order.append(name)
        prev, self._current = self._current, name
        try:
            yield self
        finally:
            self._current = prev

    def record(self, sent, received) -> None:
        """Record one traffic entry: scalars or (t,) per-machine counts."""
        name = self._current
        if name is None:
            name = "(untagged)"
        if name not in self._phase_order:
            self._phase_order.append(name)
        self._entry_phase.append(name)
        self._entries.append((torch.as_tensor(sent, dtype=torch.float32),
                              torch.as_tensor(received, dtype=torch.float32)))

    def all_gather(self, x: torch.Tensor, *, count=None,
                   track: bool = True) -> torch.Tensor:
        """x: (t, c, ...), machine i's contribution in row i.  Returns the
        gathered array every machine sees (the operand itself).

        ``count`` (scalar or (t,)) overrides each machine's sent count,
        c by default; every machine receives the sum over machines.
        """
        if track:
            t, c = x.shape[:2]
            sent = torch.as_tensor(c if count is None else count)
            sent = sent.expand(t) if sent.dim() == 0 else sent
            self.record(sent=sent, received=sent.sum().expand(t))
        return x

    def all_to_all(self, x: torch.Tensor, *, sent=None, pad=None,
                   track: bool = True) -> torch.Tensor:
        """x: (t_src, t_dst, ...) send tiles; returns (t_dst, t_src, ...).

        ``sent`` defaults to every element of a machine's tile; ``pad``
        makes the received count sentinel-aware.
        """
        out = x.transpose(0, 1).contiguous()
        if not track:
            return out
        t = x.shape[0]
        per_machine = int(np.prod(x.shape[1:]))
        s = sent if sent is not None else torch.full((t,), per_machine)
        r = (out < pad).reshape(t, -1).sum(dim=1) if pad is not None \
            else torch.full((t,), per_machine)
        self.record(sent=s, received=r)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x: (t,) per-machine values -> their sum, which every machine
        sees.  A control scalar: not counted."""
        return x.sum()

    def phases(self, t: int):
        """Merge the records into one PhaseStats per declared phase."""
        from ..core.alpha_k import PhaseStats
        sent: Dict[str, np.ndarray] = {p: np.zeros(t) for p in self._phase_order}
        recv: Dict[str, np.ndarray] = {p: np.zeros(t) for p in self._phase_order}
        for name, (s, r) in zip(self._entry_phase, self._entries):
            sent[name] = sent[name] + np.broadcast_to(s.cpu().numpy(), (t,))
            recv[name] = recv[name] + np.broadcast_to(r.cpu().numpy(), (t,))
        return [PhaseStats(p, sent[p], recv[p]) for p in self._phase_order]

    def report(self, *, algorithm: str, t: int, n_in: int, n_out: int,
               workload):
        from ..core.alpha_k import AlphaKReport
        return AlphaKReport(algorithm=algorithm, t=t, n_in=n_in, n_out=n_out,
                            workload=np.asarray(workload).reshape(-1),
                            phases=self.phases(t))
