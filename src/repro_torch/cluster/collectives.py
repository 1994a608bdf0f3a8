"""Instrumented collectives -- the (alpha, k) accounting layer.

Counterpart of ``src/repro/cluster/collectives.py`` (``CollectiveTape``).
torch has no named-axis collectives, so the port writes every body
batched over the machines it holds: each tensor carries the machine
axis first, one row a machine, and a collective is an operation on
that axis.  :class:`CollectiveTape` holds all t machines (the
``BatchedSubstrate``: every row, so a collective is a tensor operation);
:class:`ProcessGroupTape` holds the t / world machines of one rank of a
``torch.distributed`` group (the ``ProcessGroupSubstrate``: rows
``[rank*t_loc, (rank+1)*t_loc)``), and its collectives go to the
other ranks.  Both keep one contract, so a body runs unchanged on
either:

* ``axis_index(rows)`` -- the global ids of the machines the rows
  hold, the reference's ``lax.axis_index``.
* ``all_gather``  -- every machine receives the same (t, c) array, the
  machine-major operand of all t machines (on the batch, the operand
  itself).  sent = c per machine (or the caller's ``count``),
  received = the sum of what was sent.
* ``all_to_all``  -- (rows, t_dst, C) send tiles become (rows, t_src, C)
  landed tiles: tile [i, k] lands on machine k at place i (on the
  batch, a transpose of the first two axes).  sent is the caller's
  off-machine count; received counts the landed slots below ``pad``
  (sentinel-aware), per machine, or the caller's ``received`` count.

Either takes ``track=False`` for a payload that rides along an
exchange already counted (the paper counts objects: a key and its
payload are one object).
* ``all_gather_multi`` / ``staged_all_to_all`` -- the staged
  exchange's two-hop collectives over a (t1, t2) grid (machine
  g = i1*t2 + i2 at (i1, i2); sub-axis "i1" is ``axis=0``, "i2"
  ``axis=1``), each hop recorded on its own.
* ``psum``        -- a sum over the machines; O(1) control scalars are
  not counted.
* ``ragged_all_to_all`` -- exact-size segments into receive buffers, the
  reference's ``lax.ragged_all_to_all``; a process group's only (the
  batch raises, as the reference's ``vmap`` has no ragged batching).

Each also runs on one axis of an (a, b) machine grid, the counterpart
of the reference's named sub-axes (RandJoin's machine matrix): with
``grid=(a, b)`` machine i*b + j sits at (i, j), and ``axis=0`` works
within each column (the members (*, j)), ``axis=1`` within each row
(the members (i, *)).  A grid ``all_to_all`` takes (rows, n_axis, ...)
tiles and lands tile k of (i, j) on the line's k-th member; a grid
``all_gather`` returns (rows, n_axis, ...): every member sees its
line's operands, its received count the sum of the line's counts, as
``lax.psum`` over the axis gives it; a grid ``psum`` sums over the
line.

Phases are declared with ``tape.phase(name)``; alpha is the number of
declared phases, and a phase with no traffic still counts.  Counts are
recorded as (rows,) float32 tensors, as the reference records float32
scalars per device, and read back to the host once, in :meth:`phases`.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs import trace as obs_trace
from . import compat

# repro_torch.core.alpha_k is imported inside phases()/report(): the
# core modules import this one at load time.

__all__ = ["CollectiveTape", "ProcessGroupTape"]


def _host(x: torch.Tensor) -> torch.Tensor:
    """x on the host: a card's tensor read under a ``sync:tape.counts``
    span (a blocking device-to-host copy)."""
    with obs_trace.sync("tape.counts", x.is_cuda):
        return x.cpu()


def _line_sum(x: torch.Tensor, grid: Optional[Tuple[int, int]],
              axis: int) -> torch.Tensor:
    """(t,) per-machine values -> (t,) sums over each machine's line of
    the (a, b) grid along ``axis`` (over all t machines without one)."""
    if grid is None:
        return x.sum().expand(x.shape[0])
    xr = x.reshape(grid)
    return xr.sum(dim=axis, keepdim=True).expand(grid).reshape(-1)


def _line_members(ids: torch.Tensor, grid: Tuple[int, int],
                  axis: int) -> torch.Tensor:
    """(rows,) machine ids -> (rows, n_axis) the ids of each one's line
    along ``axis`` of the (a, b) grid, in line order."""
    b = grid[1]
    k = torch.arange(grid[axis], device=ids.device)
    if axis == 0:                         # (i, j) sees (*, j): column j
        return k[None, :] * b + (ids % b)[:, None]
    return (ids // b)[:, None] * b + k[None, :]   # row i


class CollectiveTape:
    """Records per-machine collective traffic of one batched execution:
    all t machines, one row each."""

    def __init__(self) -> None:
        self._phase_order: List[str] = []
        self._entry_phase: List[str] = []
        self._entry_kind: List[str] = []     # the collective of each record
        self._entries: List = []             # (sent, received) per record
        self._current: Optional[str] = None
        # phase name -> its first live ``phase:<name>`` span (a trace open)
        self.phase_spans: Dict[str, "obs_trace.Span"] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Declare a synchronized round; records inside merge into it.
        The round is a live ``phase:<name>`` span (``obs.trace.span``)."""
        if name not in self._phase_order:
            self._phase_order.append(name)
        prev, self._current = self._current, name
        try:
            with obs_trace.span(f"phase:{name}") as sp:
                if sp is not None:
                    self.phase_spans.setdefault(name, sp)
                yield self
        finally:
            self._current = prev

    def _entry_name(self) -> str:
        name = self._current if self._current is not None else "(untagged)"
        if name not in self._phase_order:
            self._phase_order.append(name)
        return name

    def record(self, sent, received, kind: str = "record") -> None:
        """Record one traffic entry: scalars or (t,) per-machine counts,
        and the collective that moved it (``"all-gather"``,
        ``"all-to-all"``; ``"record"`` for a count a caller records
        itself)."""
        self._entry_phase.append(self._entry_name())
        self._entry_kind.append(kind)
        self._entries.append((torch.as_tensor(sent, dtype=torch.float32),
                              torch.as_tensor(received, dtype=torch.float32)))

    # -- where the machines live: what a process-group tape overrides --

    def axis_index(self, rows: int, device=None) -> torch.Tensor:
        """(rows,) global ids of the machines this tape's rows hold, the
        reference's ``lax.axis_index``: all of them, ``arange(t)``."""
        return torch.arange(rows, device=device)

    def replicated(self, x):
        """Mark a body output every machine holds whole (a psum'd count,
        the boundaries) rather than one row a machine; returns it.  The
        batch's outputs are whole already."""
        return x

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, ...) -> the (t, ...) operand of all machines."""
        return x

    def _route(self, x: torch.Tensor, grid: Optional[Tuple[int, int]],
               axis: int) -> torch.Tensor:
        """The all-to-all's data movement: tile [i, k] to its line's
        k-th member, at i's place in the line."""
        if grid is None:
            return x.transpose(0, 1).contiguous()
        a, b = grid
        xr = x.reshape(a, b, *x.shape[1:])      # [i, j, k, ...]
        out = xr.transpose(0, 2) if axis == 0 else xr.transpose(1, 2)
        return out.contiguous().reshape(x.shape)

    def _line_totals(self, sent: torch.Tensor,
                     grid: Optional[Tuple[int, int]], axis: int):
        """A gather's received counts: the sum of ``sent`` over each
        machine's line."""
        return _line_sum(sent, grid, axis)

    # -- the collectives --

    def all_gather(self, x: torch.Tensor, *, count=None,
                   track: bool = True, grid: Optional[Tuple[int, int]] = None,
                   axis: int = 0) -> torch.Tensor:
        """x: (rows, c, ...), machine i's contribution in its row.
        Returns the gathered (t, c, ...) array every machine sees; on a
        ``grid``, (rows, n_axis, c, ...), each machine's line's operands.

        ``count`` (scalar or (rows,)) overrides each machine's sent
        count, c by default; every machine receives the sum over its
        line (all machines without a grid).
        """
        if track:
            self._record_gather(x.shape[1] if count is None else count,
                                x.shape[0], grid, axis)
        whole = self._whole(x)
        if grid is None:
            return whole
        ids = self.axis_index(x.shape[0], x.device)
        return whole[_line_members(ids, grid, axis)]

    def _record_gather(self, count, rows: int,
                       grid: Optional[Tuple[int, int]], axis: int):
        """Record a gather of ``count`` objects a machine (scalar or
        (rows,)); each receives the sum over its line.  Returns the
        (rows,) sent counts."""
        sent = torch.as_tensor(count)
        sent = sent.expand(rows) if sent.dim() == 0 else sent
        self.record(sent=sent, received=self._line_totals(sent, grid, axis),
                    kind="all-gather")
        return sent

    def all_gather_multi(self, x: torch.Tensor, *,
                         grid: Tuple[int, int]) -> torch.Tensor:
        """The staged gather: over i2 (``axis=1``), then over i1
        (``axis=0``).  Returns what the flat gather returns, the (t, c,
        ...) operand in global machine order.  Each hop is recorded on
        its own -- the relayed copies transit the network twice -- the
        second with each machine's count times t2 (what it relays), as
        the reference's ``c * lax.psum(1, name)``."""
        rows, c = x.shape[:2]
        sent = self._record_gather(c, rows, grid, 1)
        self._record_gather(sent * grid[1], rows, grid, 0)
        return self._whole(x)

    def staged_all_to_all(self, keys_buf: torch.Tensor, *,
                          grid: Tuple[int, int], values_buf=None, sent=None,
                          pad=None, restage=None, chunks: int = 1,
                          chunk_fn=None, phase_prefix: str = "shuffle"):
        """Two-hop exchange over the (t1, t2) grid (AMS-style staging).

        Stage 1 is one all-to-all over i1: tile g of each machine's
        (t1, C1) ``keys_buf`` goes to machine group g.  Between the hops
        ``restage(landed_keys, landed_values)`` maps the (rows, t1, C1)
        landing to ``(buf2, vals2, sent2)``, buf2 (rows, t2, C2) with
        tile d addressed to machine (i1, d).  Without ``restage`` a pure
        relay runs: ``keys_buf`` is then (rows, t1, t2, C), block [g, d]
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
        rows = keys_buf.shape[0]
        if restage is not None:
            buf2, vals2, sent2 = restage(rk, rv)
        else:
            if rk.dim() < 4:
                raise ValueError("relay staging needs a (rows, t1, t2, ...) "
                                 "buffer; pass restage= for other layouts")

            def swap(y):    # (rows, t1, t2, C, ...) -> (rows, t2, t1*C, ...)
                y = y.transpose(1, 2)
                return y.reshape(rows, y.shape[1], -1, *y.shape[4:])

            buf2 = swap(rk)
            vals2 = None if rv is None else swap(rv)
            if pad is not None:
                vrow = (buf2 < pad).reshape(rows, buf2.shape[1], -1).sum(dim=2)
                own = self.axis_index(rows, buf2.device) % grid[1]
                sent2 = (vrow.sum(dim=1)
                         - vrow[torch.arange(rows, device=buf2.device), own])
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
                s = sent2 if j == 0 else torch.zeros(rows)
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
        """x: (rows, t_dst, ...) send tiles; returns (rows, t_src, ...).

        On a ``grid``, x is (rows, n_axis, ...): tile k of each machine
        goes to the k-th member of its line, and lands at the sender's
        place in the line.  ``sent`` defaults to every element of a
        machine's tile; ``pad`` makes the received count sentinel-aware.
        ``received`` ((rows,) or a scalar) gives the landed count of
        tiles with no sentinel (the MoE return trip's dense payload
        rows: only the caller knows how many carry real objects); it
        wins over ``pad``.
        """
        out = self._route(x, grid, axis)
        if not track:
            return out
        rows = x.shape[0]
        per_machine = int(np.prod(x.shape[1:]))
        s = sent if sent is not None else torch.full((rows,), per_machine)
        if received is not None:
            r = received
        elif pad is not None:
            r = (out < pad).reshape(rows, -1).sum(dim=1)
        else:
            r = torch.full((rows,), per_machine)
        self.record(sent=s, received=r, kind="all-to-all")
        return out

    def ragged_all_to_all(self, operand, output, input_offsets, send_sizes,
                          output_offsets, recv_sizes, *, sent=None,
                          track: bool = True):
        """Exact-size exchange: a process group's only.  The reference's
        ragged backend has no batching rule under ``vmap`` and raises
        there too."""
        raise NotImplementedError(
            "the ragged exchange runs on a ProcessGroupSubstrate only: the "
            "BatchedSubstrate's machines are one tensor, as the reference's "
            "vmap substrate has no ragged_all_to_all; use backend='static'")

    def psum(self, x: torch.Tensor, *,
             grid: Optional[Tuple[int, int]] = None,
             axis: int = 0) -> torch.Tensor:
        """x: (rows,) per-machine values -> their sum, which every
        machine sees; on a ``grid``, (rows,) sums over each machine's
        line.  A control scalar: not counted."""
        if grid is None:
            return x.sum()
        return _line_sum(x, grid, axis)

    # -- the host side --

    def _host_entries(self, t: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Each record's (sent, received) as (t,) float32 host arrays."""
        return [(np.broadcast_to(_host(s).numpy(), (t,)),
                 np.broadcast_to(_host(r).numpy(), (t,)))
                for s, r in self._entries]

    def received_by_kind(self, t: int) -> Dict[str, np.ndarray]:
        """Collective kind -> the (t,) objects each machine received
        through it, summed over the records."""
        out: Dict[str, np.ndarray] = {}
        for kind, (_, r) in zip(self._entry_kind, self._host_entries(t)):
            out[kind] = out.get(kind, np.zeros(t)) + r
        return out

    def phases(self, t: int):
        """Merge the records into one PhaseStats per declared phase."""
        from ..core.alpha_k import PhaseStats
        sent: Dict[str, np.ndarray] = {p: np.zeros(t) for p in self._phase_order}
        recv: Dict[str, np.ndarray] = {p: np.zeros(t) for p in self._phase_order}
        for name, (s, r) in zip(self._entry_phase, self._host_entries(t)):
            sent[name] = sent[name] + s
            recv[name] = recv[name] + r
        return [PhaseStats(p, sent[p], recv[p]) for p in self._phase_order]

    def report(self, *, algorithm: str, t: int, n_in: int, n_out: int,
               workload):
        from ..core.alpha_k import AlphaKReport
        return AlphaKReport(algorithm=algorithm, t=t, n_in=n_in, n_out=n_out,
                            workload=np.asarray(workload).reshape(-1),
                            phases=self.phases(t))


# ---------------------------------------------------------------------------
# One rank of a process group
# ---------------------------------------------------------------------------

class _LineTotals(NamedTuple):
    """A gather's received counts, left for :meth:`ProcessGroupTape.bind`:
    the sums over lines span ranks, and the one gather of all the
    records brings every machine's sent count to every rank."""
    grid: Optional[Tuple[int, int]]
    axis: int


class _RoutePlan(NamedTuple):
    send: Optional[torch.Tensor]    # local tile order of the send buffer
    in_splits: Tuple[int, ...]      # tiles to each rank
    out_splits: Tuple[int, ...]     # tiles from each rank
    land: Optional[torch.Tensor]    # received tile of each output slot


@functools.lru_cache(maxsize=256)
def _route_plan(t: int, world: int, rank: int, n: int,
                grid: Optional[Tuple[int, int]], axis: int,
                device: torch.device) -> _RoutePlan:
    """Where every tile of an all-to-all goes, for one rank.

    Machine g's tile k goes to machine d at place p of d's n landed
    tiles: (k, g) flat, (k*b + j, i) within a grid's column, (i*b + k,
    j) within its row.  A rank sends its tiles ordered by the
    destination's rank (machine-major within) and lands what each rank
    sends, in rank order; ``land`` puts them at their places.  None
    stands for the identity.  The index tensors live on ``device``,
    made once: a copy from pageable host memory would wait for the
    device at every call.
    """
    rows = t // world
    g = np.repeat(np.arange(t), n)
    k = np.tile(np.arange(n), t)
    if grid is None:
        d, p = k, g
    else:
        b = grid[1]
        i, j = g // b, g % b
        d, p = (k * b + j, i) if axis == 0 else (i * b + k, j)
    src, dst = g // rows, d // rows
    mine = np.nonzero(src == rank)[0]
    send = mine[np.argsort(dst[mine], kind="stable")] - rank * rows * n
    to_me = np.nonzero(dst == rank)[0]     # by source rank, each in its order
    land = np.argsort((d[to_me] - rank * rows) * n + p[to_me])
    ident = np.arange(rows * n)
    return _RoutePlan(
        None if np.array_equal(send, ident)
        else torch.from_numpy(send).to(device),
        tuple(np.bincount(dst[mine], minlength=world).tolist()),
        tuple(np.bincount(src[to_me], minlength=world).tolist()),
        None if np.array_equal(land, ident)
        else torch.from_numpy(land).to(device))


def _row_bytes(x: torch.Tensor) -> torch.Tensor:
    """(rows, ...) -> (rows, bytes a row) uint8: collectives move bytes,
    so every dtype (bf16, bool, a NaN's payload) travels as it is."""
    flat = x.contiguous().view(-1)
    if flat.stride(0) != 1:      # a lone element keeps its source's stride
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat.view(torch.uint8).reshape(x.shape[0], -1)


def _from_bytes(b: torch.Tensor, like: torch.Tensor,
                rows: int) -> torch.Tensor:
    return b.view(like.dtype).reshape(rows, *like.shape[1:])


class ProcessGroupTape(CollectiveTape):
    """The tape of one rank of a ``torch.distributed`` group.

    The rank holds the machines ``[rank*t_loc, (rank+1)*t_loc)``, one
    row each; every collective goes to the other ranks of ``group``,
    and every rank must take the same collectives in the same order.
    Data moves as bytes: a gather is one ``all_gather_single``, an
    all-to-all (flat or along a grid line) one ``all_to_all_single``
    whose split sizes send each tile to its destination machine's rank,
    then one local permutation -- a line of the grid may span ranks, or
    share a rank with others, for any t_loc, and one collective over the
    whole group keeps every rank in step without a sub-group a line.

    Gloo and CUDA: the Gloo backend does not take CUDA tensors in every
    collective the tape needs, so for a group whose backend is not NCCL
    each collective of a CUDA operand stages it through pinned host
    memory, decided from the backend before the call (never by catching
    a failure); ``host_staged`` says whether a run did.

    Records are (t_loc,) per machine; :meth:`bind` reads every rank's in
    one gather, after which every rank holds the same whole report.
    """

    def __init__(self, group, t: int) -> None:
        super().__init__()
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.t = int(t)
        self.rows = self.t // self.world
        self.lo = self.rank * self.rows
        self._nccl = "nccl" in str(dist.get_backend(group)).lower()
        self.host_staged = False
        self._replicated: List = []
        self._bound: Optional[List] = None

    def axis_index(self, rows: int, device=None) -> torch.Tensor:
        if rows != self.rows:
            raise ValueError(f"rank {self.rank} holds {self.rows} machines; "
                             f"an operand has {rows} rows")
        return torch.arange(self.lo, self.lo + rows, device=device)

    def replicated(self, x):
        self._replicated.append(x)
        return x

    def is_replicated(self, x) -> bool:
        return any(x is y for y in self._replicated)

    def _local(self, whole: torch.Tensor) -> torch.Tensor:
        return whole[self.lo:self.lo + self.rows]

    def _collective(self, fn, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``fn(out, inp)`` on the group, through pinned host buffers
        where the group's backend is not NCCL and the operand lies on a
        CUDA device."""
        if not (inp.is_cuda and not self._nccl):
            fn(out, inp)
            return
        self.host_staged = True
        h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        h_in.copy_(inp)
        h_out = (h_in if out is inp else
                 torch.empty(out.shape, dtype=out.dtype, pin_memory=True))
        fn(h_out, h_in)
        out.copy_(h_out)

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        b = _row_bytes(x)
        out = torch.empty((self.world * b.shape[0], b.shape[1]),
                          dtype=torch.uint8, device=b.device)
        self._collective(
            lambda o, i: compat.all_gather_rows(o, i, group=self.group),
            out, b)
        return _from_bytes(out, x, self.world * x.shape[0])

    def _exchange_rows(self, send: torch.Tensor, in_splits,
                       out_splits) -> torch.Tensor:
        """Rows of ``send`` to each rank by ``in_splits``; returns the
        rows each rank sends here, in rank order."""
        b = _row_bytes(send)
        out = torch.empty((sum(out_splits), b.shape[1]), dtype=torch.uint8,
                          device=b.device)
        self._collective(lambda o, i: compat.ragged_all_to_all(
            o, i, out_splits, in_splits, group=self.group), out, b)
        return _from_bytes(out, send, out.shape[0])

    def _route(self, x: torch.Tensor, grid: Optional[Tuple[int, int]],
               axis: int) -> torch.Tensor:
        n = x.shape[1]
        if n != (self.t if grid is None else grid[axis]):
            raise ValueError(f"all_to_all tiles of shape {tuple(x.shape)} on "
                             f"{'the flat group' if grid is None else grid}")
        plan = _route_plan(self.t, self.world, self.rank, n, grid, axis,
                           x.device)
        flat = x.reshape(x.shape[0] * n, *x.shape[2:])
        if plan.send is not None:
            flat = flat[plan.send]
        landed = self._exchange_rows(flat, plan.in_splits, plan.out_splits)
        if plan.land is not None:
            landed = landed[plan.land]
        return landed.reshape(x.shape)

    def _line_totals(self, sent, grid, axis):
        return _LineTotals(grid, axis)

    def psum(self, x: torch.Tensor, *,
             grid: Optional[Tuple[int, int]] = None,
             axis: int = 0) -> torch.Tensor:
        """The flat sum is one ``all_reduce`` of each rank's partial sum:
        exact for the integer counts the bodies sum (a float sum may
        round in another order than the batch's).  A grid's line sums
        gather the whole (t,) vector and sum it as the batch does."""
        if grid is not None:
            return self._local(_line_sum(self._whole(x), grid, axis))
        total = x.sum().reshape(1)
        self._collective(lambda o, i: dist.all_reduce(o, group=self.group),
                         total, total)
        return total[0]

    def ragged_all_to_all(self, operand, output, input_offsets, send_sizes,
                          output_offsets, recv_sizes, *, sent=None,
                          track: bool = True):
        """Machine g's ``send_sizes[g, d]`` objects from
        ``input_offsets[g, d]`` of its row of ``operand`` land at
        ``output_offsets[g, d]`` of machine d's row of ``output`` (the
        (rows, t) offsets index the receiver's buffer, as the
        reference's).  ``recv_sizes[d, g]`` is what d receives from g.
        Each receiver learns its segments' sizes and offsets from their
        senders in one all-to-all of (size, offset) pairs; a segment
        past the receive buffer raises.  Returns ``output`` with the
        segments written (a new tensor).  Recorded as the reference
        records it: sent = ``sent`` or the sizes sent, received = the
        sizes received."""
        rows, n = operand.shape[:2]
        cap = output.shape[1]
        dev = operand.device
        meta = torch.stack([send_sizes.long(), output_offsets.long()], dim=-1)
        landed = self._route(meta, None, 0).cpu()      # (rows, t_src, 2)
        sizes = send_sizes.long().cpu()
        starts = input_offsets.long().cpu()
        r = self.rows
        # send: to each rank, its machines' segments, machine-major, each
        # from all of mine
        send_len = sizes.reshape(rows, self.world, r).permute(1, 2, 0)
        send_at = (starts + torch.arange(rows)[:, None] * n).reshape(
            rows, self.world, r).permute(1, 2, 0)
        in_splits = send_len.reshape(self.world, -1).sum(1).tolist()
        # land: from each rank, my machines' segments, each from all of its
        land_len = landed[..., 0].reshape(rows, self.world, r).permute(1, 0, 2)
        land_off = landed[..., 1].reshape(rows, self.world, r).permute(1, 0, 2)
        if bool(((land_off < 0) | (land_off + land_len > cap)).any()):
            raise ValueError(f"ragged_all_to_all: a segment lands past the "
                             f"{cap}-slot receive buffer")
        land_at = land_off + torch.arange(rows)[None, :, None] * cap
        out_splits = land_len.reshape(self.world, -1).sum(1).tolist()
        src = _segment_index(send_at.reshape(-1).to(dev),
                             send_len.reshape(-1).to(dev), sum(in_splits))
        dst = _segment_index(land_at.reshape(-1).to(dev),
                             land_len.reshape(-1).to(dev), sum(out_splits))
        got = self._exchange_rows(
            operand.reshape(rows * n, *operand.shape[2:])[src],
            in_splits, out_splits)
        out = output.clone()
        out.reshape(rows * cap, *output.shape[2:])[dst] = got
        if track:
            s = sent if sent is not None else send_sizes.sum(dim=1)
            self.record(sent=s, received=recv_sizes.sum(dim=1),
                        kind="all-to-all")
        return out

    def record(self, sent, received, kind: str = "record") -> None:
        """As :meth:`CollectiveTape.record`, each count (rows,) per
        machine; a gather's received counts wait for :meth:`bind`."""
        self._entry_phase.append(self._entry_name())
        self._entry_kind.append(kind)
        s = torch.as_tensor(sent, dtype=torch.float32).expand(self.rows)
        if not isinstance(received, _LineTotals):
            received = torch.as_tensor(received, dtype=torch.float32
                                       ).expand(self.rows)
        self._entries.append((s, received))

    def bind(self) -> None:
        """Read every rank's records in one gather (a collective: every
        rank calls it once, after its body).  Idempotent."""
        if self._bound is not None:
            return
        cols = []
        for s, r in self._entries:      # read to the host, as the batch's
            cols.append(_host(s))
            cols.append(torch.zeros(self.rows) if isinstance(r, _LineTotals)
                        else _host(r))
        if cols:        # every rank records the same entries
            local = torch.stack(cols, dim=1)                 # (rows, 2R)
            if self._nccl:
                local = local.to(torch.device(
                    "cuda", torch.cuda.current_device()))
            counts = _host(self._whole(local).T).numpy()     # (2R, t)
        bound = []
        for e, (_, r) in enumerate(self._entries):
            s, got = counts[2 * e], counts[2 * e + 1]
            if isinstance(r, _LineTotals):
                got = _host_line_sum(s, r.grid, r.axis)
            bound.append((s, got))
        self._bound = bound

    def _host_entries(self, t: int):
        if t != self.t:
            raise ValueError(f"the tape ran {self.t} machines, not {t}")
        self.bind()
        return self._bound


def _host_line_sum(sent: np.ndarray, grid: Optional[Tuple[int, int]],
                   axis: int) -> np.ndarray:
    """The batch's ``_line_sum`` of float32 counts, on the host: integer
    counts sum exactly in float64, then round to float32 as the batch's
    integer sums do when recorded."""
    x = sent.astype(np.float64)
    if grid is None:
        out = np.full(x.shape, x.sum())
    else:
        out = np.broadcast_to(x.reshape(grid).sum(axis=axis, keepdims=True),
                              grid).reshape(-1)
    return out.astype(np.float32)


def _segment_index(starts: torch.Tensor, lens: torch.Tensor,
                   total: int) -> torch.Tensor:
    """The positions of segments [starts[i], starts[i] + lens[i]), in
    segment order; ``total`` is the sum of ``lens`` (known on the host,
    so the device computes it without a sync)."""
    base = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens),
                                   lens, output_size=total)
    return base + torch.arange(total, device=starts.device)
