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
  slots below ``pad`` (sentinel-aware), per machine, or the caller's
  ``received`` count.

Either takes ``track=False`` for a payload that rides along an
exchange already counted (the paper counts objects: a key and its
payload are one object).
* ``all_gather_multi`` / ``staged_all_to_all`` -- the staged
  exchange's two-hop collectives over a (t1, t2) grid (machine
  g = i1*t2 + i2 at (i1, i2); sub-axis "i1" is ``axis=0``, "i2"
  ``axis=1``), each hop recorded on its own.
* ``psum``        -- a sum over the machine axis; O(1) control scalars
  are not counted.

Each also runs on one axis of an (a, b) machine grid, the counterpart
of the reference's named sub-axes (RandJoin's machine matrix): with
``grid=(a, b)`` machine i*b + j sits at (i, j), and ``axis=0`` works
within each column (the members (*, j)), ``axis=1`` within each row
(the members (i, *)).  A grid ``all_to_all`` takes (t, n_axis, ...)
tiles and lands tile k of (i, j) on the line's k-th member; a grid
``all_gather`` returns (t, n_axis, ...): every member sees its line's
operands, its received count the sum of the line's counts, as
``lax.psum`` over the axis gives it; a grid ``psum`` sums over the
line.

Phases are declared with ``tape.phase(name)``; alpha is the number of
declared phases, and a phase with no traffic still counts.  Counts are
recorded as (t,) float32 tensors, as the reference records float32
scalars per device, and read back to the host once, in :meth:`phases`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# repro_torch.core.alpha_k is imported inside phases()/report(): the
# core modules import this one at load time.

__all__ = ["CollectiveTape"]


def _line_sum(x: torch.Tensor, grid: Optional[Tuple[int, int]],
              axis: int) -> torch.Tensor:
    """(t,) per-machine values -> (t,) sums over each machine's line of
    the (a, b) grid along ``axis`` (over all t machines without one)."""
    if grid is None:
        return x.sum().expand(x.shape[0])
    xr = x.reshape(grid)
    return xr.sum(dim=axis, keepdim=True).expand(grid).reshape(-1)


class CollectiveTape:
    """Records per-machine collective traffic of one batched execution."""

    def __init__(self) -> None:
        self._phase_order: List[str] = []
        self._entry_phase: List[str] = []
        self._entry_kind: List[str] = []     # the collective of each record
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

    def record(self, sent, received, kind: str = "record") -> None:
        """Record one traffic entry: scalars or (t,) per-machine counts,
        and the collective that moved it (``"all-gather"``,
        ``"all-to-all"``; ``"record"`` for a count a caller records
        itself)."""
        name = self._current
        if name is None:
            name = "(untagged)"
        if name not in self._phase_order:
            self._phase_order.append(name)
        self._entry_phase.append(name)
        self._entry_kind.append(kind)
        self._entries.append((torch.as_tensor(sent, dtype=torch.float32),
                              torch.as_tensor(received, dtype=torch.float32)))

    def all_gather(self, x: torch.Tensor, *, count=None,
                   track: bool = True, grid: Optional[Tuple[int, int]] = None,
                   axis: int = 0) -> torch.Tensor:
        """x: (t, c, ...), machine i's contribution in row i.  Returns the
        gathered array every machine sees (the operand itself); on a
        ``grid``, (t, n_axis, c, ...), each machine's line's operands.

        ``count`` (scalar or (t,)) overrides each machine's sent count,
        c by default; every machine receives the sum over its line (all
        machines without a grid).
        """
        t, c = x.shape[:2]
        if track:
            self._record_gather(c if count is None else count, t, grid, axis)
        if grid is None:
            return x
        a, b = grid
        xr = x.reshape(a, b, *x.shape[1:])
        if axis == 0:                 # (i, j) sees (*, j): column j
            out = xr.transpose(0, 1).unsqueeze(0).expand(a, b, a,
                                                         *x.shape[1:])
        else:                         # (i, j) sees (i, *): row i
            out = xr.unsqueeze(1).expand(a, b, b, *x.shape[1:])
        return out.reshape(t, grid[axis], *x.shape[1:])

    def _record_gather(self, count, t: int,
                       grid: Optional[Tuple[int, int]], axis: int):
        """Record a gather of ``count`` objects a machine (scalar or
        (t,)); each receives the sum over its line.  Returns the (t,)
        sent counts."""
        sent = torch.as_tensor(count)
        sent = sent.expand(t) if sent.dim() == 0 else sent
        self.record(sent=sent, received=_line_sum(sent, grid, axis),
                    kind="all-gather")
        return sent

    def all_gather_multi(self, x: torch.Tensor, *,
                         grid: Tuple[int, int]) -> torch.Tensor:
        """The staged gather: over i2 (``axis=1``), then over i1
        (``axis=0``).  Returns what the flat gather returns, the (t, c,
        ...) operand itself in global machine order.  Each hop is
        recorded on its own -- the relayed copies transit the network
        twice -- the second with each machine's count times t2 (what it
        relays), as the reference's ``c * lax.psum(1, name)``."""
        t, c = x.shape[:2]
        sent = self._record_gather(c, t, grid, 1)
        self._record_gather(sent * grid[1], t, grid, 0)
        return x

    def staged_all_to_all(self, keys_buf: torch.Tensor, *,
                          grid: Tuple[int, int], values_buf=None, sent=None,
                          pad=None, restage=None, chunks: int = 1,
                          chunk_fn=None, phase_prefix: str = "shuffle"):
        """Two-hop exchange over the (t1, t2) grid (AMS-style staging).

        Stage 1 is one all-to-all over i1: tile g of each machine's
        (t1, C1) ``keys_buf`` goes to machine group g.  Between the hops
        ``restage(landed_keys, landed_values)`` maps the (t, t1, C1)
        landing to ``(buf2, vals2, sent2)``, buf2 (t, t2, C2) with tile d
        addressed to machine (i1, d).  Without ``restage`` a pure relay
        runs: ``keys_buf`` is then (t, t1, t2, C), block [g, d]
        addressed to machine (g, d), and the stage-2 landing, reassembled
        source-major, equals the flat all-to-all of the same buffer.

        Stage 2 runs in ``chunks`` column slices of buf2 (``chunks``
        divides C2); ``chunk_fn(keys, values)`` runs on each landed
        chunk, between the chunked exchanges.  Each stage records into
        its own phase, ``"<prefix> s1"`` / ``"<prefix> s2"``; a chunk
        after the first sends nothing new.  Returns ``(chunk_outputs,
        sent2)``.
        """
        with self.phase(f"{phase_prefix} s1"):
            rk = self.all_to_all(keys_buf, sent=sent, pad=pad, grid=grid,
                                 axis=0)
            rv = (None if values_buf is None else
                  self.all_to_all(values_buf, track=False, grid=grid,
                                  axis=0))
        t = keys_buf.shape[0]
        if restage is not None:
            buf2, vals2, sent2 = restage(rk, rv)
        else:
            if rk.dim() < 4:
                raise ValueError("relay staging needs a (t, t1, t2, ...) "
                                 "buffer; pass restage= for other layouts")

            def swap(y):        # (t, t1, t2, C, ...) -> (t, t2, t1*C, ...)
                y = y.transpose(1, 2)
                return y.reshape(t, y.shape[1], -1, *y.shape[4:])

            buf2 = swap(rk)
            vals2 = None if rv is None else swap(rv)
            if pad is not None:
                vrow = (buf2 < pad).reshape(t, buf2.shape[1], -1).sum(dim=2)
                own = torch.arange(t, device=buf2.device) % grid[1]
                sent2 = vrow.sum(dim=1) - vrow[torch.arange(t), own]
            else:
                sent2 = torch.tensor(
                    (buf2.shape[1] - 1) * int(np.prod(buf2.shape[2:])))
        chunks = max(1, int(chunks))
        width = buf2.shape[2]
        if width % chunks != 0:
            raise ValueError(f"chunks={chunks} must divide the stage-2 "
                             f"row length {width}")
        cc = width // chunks
        outs = []
        with self.phase(f"{phase_prefix} s2"):
            for j in range(chunks):
                ck = buf2[:, :, j * cc:(j + 1) * cc]
                cv = None if vals2 is None else vals2[:, :, j * cc:(j + 1) * cc]
                s = sent2 if j == 0 else torch.zeros(t)
                ok = self.all_to_all(ck, sent=s, pad=pad, grid=grid, axis=1)
                ov = (None if cv is None else
                      self.all_to_all(cv, track=False, grid=grid, axis=1))
                outs.append(chunk_fn(ok, ov) if chunk_fn is not None
                            else (ok, ov))
        return outs, sent2

    def all_to_all(self, x: torch.Tensor, *, sent=None, pad=None,
                   received=None, track: bool = True,
                   grid: Optional[Tuple[int, int]] = None,
                   axis: int = 0) -> torch.Tensor:
        """x: (t_src, t_dst, ...) send tiles; returns (t_dst, t_src, ...).

        On a ``grid``, x is (t, n_axis, ...): tile k of each machine
        goes to the k-th member of its line, and lands at the sender's
        place in the line.  ``sent`` defaults to every element of a
        machine's tile; ``pad`` makes the received count sentinel-aware.
        ``received`` ((t,) or a scalar) gives the landed count of tiles
        with no sentinel (the MoE return trip's dense payload rows: only
        the caller knows how many carry real objects); it wins over
        ``pad``.
        """
        if grid is None:
            out = x.transpose(0, 1).contiguous()
        else:
            a, b = grid
            xr = x.reshape(a, b, *x.shape[1:])      # [i, j, k, ...]
            out = xr.transpose(0, 2) if axis == 0 else xr.transpose(1, 2)
            out = out.contiguous().reshape(x.shape)
        if not track:
            return out
        t = x.shape[0]
        per_machine = int(np.prod(x.shape[1:]))
        s = sent if sent is not None else torch.full((t,), per_machine)
        if received is not None:
            r = received
        elif pad is not None:
            r = (out < pad).reshape(t, -1).sum(dim=1)
        else:
            r = torch.full((t,), per_machine)
        self.record(sent=s, received=r, kind="all-to-all")
        return out

    def psum(self, x: torch.Tensor, *,
             grid: Optional[Tuple[int, int]] = None,
             axis: int = 0) -> torch.Tensor:
        """x: (t,) per-machine values -> their sum, which every machine
        sees; on a ``grid``, (t,) sums over each machine's line.  A
        control scalar: not counted."""
        if grid is None:
            return x.sum()
        return _line_sum(x, grid, axis)

    def received_by_kind(self, t: int) -> Dict[str, np.ndarray]:
        """Collective kind -> the (t,) objects each machine received
        through it, summed over the records."""
        out: Dict[str, np.ndarray] = {}
        for kind, (_, r) in zip(self._entry_kind, self._entries):
            out[kind] = out.get(kind, np.zeros(t)) + np.broadcast_to(
                r.cpu().numpy(), (t,))
        return out

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
