"""The Round-3 shuffle, batched over the machines a tape's rows hold.

Counterpart of ``src/repro/core/exchange.py``.
Every machine cuts its locally sorted row at the t-1 interior
boundaries (or, with ``sort_input``, sorts and cuts it in one kernel,
as Terasort's Round 3 does), packs the t contiguous segments into a
(t, C) tile sentinel-padded to the capacity C that the sort's workload
theorem sizes, exchanges the tiles all-to-all and merges the t landed
sorted rows.  Values, when present, ride in a second tile (zeros in the
pad slots) through an untracked all-to-all and come out of the merge in
the keys' stable order.  The machines a tape holds (all t on the
batch, a rank's t / world in a process group; ``tape.axis_index`` says
which) do each step at once: rows, tiles and landed buffers carry the
machine axis first.

``backend="ragged"`` (a process group's only) sends each segment at
its exact size (:func:`ragged_exchange`) into the same capacity and
re-sorts the landed buffer: the reference's ragged backend.

Dropped objects (a segment longer than C) are counted, not hidden: the
caller's capacity-retry loop re-runs with a larger factor.

``staged_shape=(t1, t2)`` runs the shuffle as the reference's two-level
staged exchange (``_staged_exchange``): each machine's segments travel
to their machine group over i1, are merged and re-cut against the
group's t2-1 boundaries, and travel to their machine over i2 in
``overlap_chunks`` slices, each merged as it lands, then merged across
slices.  The boundaries are global, so every machine ends with the flat
path's keys.

:func:`exchange_routed_rows` / :func:`return_routed_rows` (the
reference's ``:188`` / ``:229``) deliver payload rows to the machine
each names and ship the processed rows home: the MoE dispatch's
shuffle, on the same sort, cut, pack and all-to-all.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..cluster.capacity import CapacityOverflowError
from ..cluster.collectives import CollectiveTape
from ..kernels import ops
from ..obs import trace as obs_trace

__all__ = ["PAD", "partition_sorted", "build_send_buffer", "static_exchange",
           "ragged_exchange", "flat_receive_capacity",
           "staged_receive_capacities",
           "ExchangeResult", "exchange_sorted_segments", "RoutedRows",
           "exchange_routed_rows", "return_routed_rows"]

# Sentinel key for padded slots.  Keys must be finite floats or ints
# strictly below it; sorts push pads to the end.
PAD = math.inf


def partition_sorted(x_sorted: torch.Tensor, interior: torch.Tensor,
                     valid_len: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split each machine's sorted row into t contiguous segments.

    x_sorted: (t, n) rows sorted ascending; interior: (t-1,) boundaries
    b_1..b_{t-1}.  Element e goes to bucket k iff b_k <= e < b_{k+1}.
    ``valid_len=m`` declares the rows padded past m real keys with the
    sort sentinel; cuts are clamped to m.  Returns (starts, lens), each
    (t, t) int32.
    """
    m = valid_len if valid_len is not None else x_sorted.shape[1]
    cuts = ops.searchsorted(x_sorted, interior, side="left",
                            valid_len=valid_len)                # (t, t-1)
    return ops.segments(cuts, m)


def build_send_buffer(x_sorted: torch.Tensor, starts: torch.Tensor,
                      lens: torch.Tensor, cap_per_pair: int,
                      values: Optional[torch.Tensor] = None,
                      valid_len: Optional[int] = None):
    """Pack each machine's t segments into a (t, C) tile, sentinel-padded.

    x_sorted: (t, n); starts/lens: (t, k) (k = t, or the t1 machine
    groups of the staged exchange); values: (t, n, ...) or None.
    ``valid_len`` is an int, or a (t,) tensor of each row's own length.
    Returns (keys_buf (t, k, C), values_buf (t, k, C, ...) with zeros in
    the pad slots or None, dropped (t,)) where dropped counts each
    machine's objects beyond the per-pair capacity.
    """
    t = starts.shape[0]
    m = valid_len if valid_len is not None else x_sorted.shape[1]
    cols = torch.arange(cap_per_pair, dtype=torch.int32,
                        device=x_sorted.device)
    idx = starts[:, :, None] + cols                           # (t, k, C)
    valid = cols < lens[:, :, None]
    if isinstance(m, torch.Tensor):
        # per-row lengths: a row of none gathers slot 0, masked below
        hi = (m.long() - 1).clamp_min(0)[:, None, None]
        safe = torch.minimum(idx.long().clamp_min(0), hi)
    else:
        safe = torch.clamp(idx, 0, m - 1).long()
    safe = safe.reshape(t, -1)
    gathered = torch.gather(x_sorted, 1, safe).reshape(idx.shape)
    keys = torch.where(valid, gathered, torch.full_like(gathered, PAD))
    vals = None
    if values is not None:
        rows = torch.arange(t, device=values.device)[:, None]
        vals = values[rows, safe].reshape(idx.shape + values.shape[2:])
        pads = ~valid.reshape(valid.shape + (1,) * (values.dim() - 2))
        vals.masked_fill_(pads, 0)      # in place: the tile is the big one
    dropped = torch.clamp_min(lens - cap_per_pair, 0).sum(dim=1)
    return keys, vals, dropped


def static_exchange(keys_buf: torch.Tensor, tape: CollectiveTape,
                    sent: torch.Tensor,
                    values_buf: Optional[torch.Tensor] = None,
                    grid: Optional[Tuple[int, int]] = None, axis: int = 0):
    """Dense all-to-all of the (t, t, C) tiles: tile [i, k] lands on k.

    Recorded with ``sent`` (each machine's off-machine objects) and the
    PAD-aware received count; the values tiles ride along untracked.
    On a ``grid`` the tiles are (t, n_axis, C) and land within each
    line of the grid along ``axis`` (``CollectiveTape.all_to_all``).
    Returns (landed keys, landed values or None).
    """
    recv_k = tape.all_to_all(keys_buf, sent=sent, pad=PAD, grid=grid,
                             axis=axis)
    recv_v = None
    if values_buf is not None:
        recv_v = tape.all_to_all(values_buf, track=False, grid=grid,
                                 axis=axis)
    return recv_k, recv_v


def ragged_exchange(x_sorted: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, capacity: int, tape: CollectiveTape,
                    values: Optional[torch.Tensor] = None, sent=None):
    """Exact-size exchange: segment k of each machine lands on machine
    k, packed after the segments of the machines before it, in a
    ``capacity``-slot receive buffer (PAD past the landed objects).

    The reference's ``ragged_exchange`` (``src/repro/core/exchange.py:139``)
    over ``tape.ragged_all_to_all``: every machine learns the whole
    (t, t) size matrix through an untracked all-gather, and so its
    receive offsets; ``values`` ride a second, untracked ragged exchange
    with the same sizes.  Theorem 1 / 3 bound the received total by the
    capacity; a machine that would receive more raises
    (``CapacityOverflowError``, on every rank alike: the size matrix is
    whole everywhere), and nothing is written past the buffer.  Returns
    (recv_keys (rows, capacity), recv_values or None, recv_count
    (rows,)).
    """
    sizes = lens.long()
    rows = sizes.shape[0]
    size_matrix = tape.all_gather(sizes, track=False)             # (t, t)
    landed = size_matrix.sum(dim=0)
    if int(landed.max()) > capacity:
        raise CapacityOverflowError(
            f"ragged exchange: a machine receives {int(landed.max())} "
            f"objects, past its {capacity}-slot buffer")
    me = tape.axis_index(rows, sizes.device)
    col_excl = torch.cumsum(size_matrix, dim=0) - size_matrix
    out_offsets = col_excl[me]                                    # (rows, t)
    recv_sizes = size_matrix[:, me].T                             # (rows, t)
    out = torch.full((rows, capacity), PAD, dtype=x_sorted.dtype,
                     device=x_sorted.device)
    recv = tape.ragged_all_to_all(x_sorted, out, starts, sizes, out_offsets,
                                  recv_sizes, sent=sent)
    recv_v = None
    if values is not None:
        out_v = torch.zeros((rows, capacity) + values.shape[2:],
                            dtype=values.dtype, device=values.device)
        recv_v = tape.ragged_all_to_all(values, out_v, starts, sizes,
                                        out_offsets, recv_sizes, track=False)
    return recv, recv_v, recv_sizes.sum(dim=1)


def flat_receive_capacity(m: int, t: int, cap_factor: float) -> int:
    """Receive-buffer slots of the flat exchange: t * ceil-per-pair."""
    return int(-(-int(cap_factor * m) // t) * t)


def staged_receive_capacities(m: int, t1: int, t2: int, cap_factor: float,
                              overlap_chunks: int = 2) -> Tuple[int, int]:
    """(stage-1, stage-2) receive-buffer slots of the staged exchange.

    Stage 1 lands (t1, C1) with C1 = ceil(cap_factor*m / t1); stage 2
    lands (t2, C2) with C2 rounded up so ``overlap_chunks`` divides it.
    """
    c1, c2 = _staged_pair_capacities(m, t1, t2, cap_factor, overlap_chunks)
    return t1 * c1, t2 * c2


def _staged_pair_capacities(m: int, t1: int, t2: int, cap_factor: float,
                            overlap_chunks: int) -> Tuple[int, int]:
    chunks = max(1, int(overlap_chunks))
    c1 = -(-int(cap_factor * m) // t1)
    c2 = -(-int(cap_factor * m) // t2)
    return c1, -(-c2 // chunks) * chunks


def _merge(keys: torch.Tensor, values: Optional[torch.Tensor]):
    """Merge (batch, rows, c) sorted rows, with their values or not."""
    if values is None:
        return ops.merge_sorted_rows(keys), None
    return ops.merge_sorted_rows_kv(keys, values)


def _staged_exchange(x_sorted, interior, starts, lens, *, t1: int, t2: int,
                     m: int, cap_factor: float, values, valid_len,
                     overlap_chunks: int, tape: CollectiveTape,
                     phase_prefix: str) -> "ExchangeResult":
    """Two-level exchange: group hop, merge, re-cut, final hop with a
    merge a landed chunk, then a merge across the chunks.

    Counterpart of the reference's ``_staged_exchange``
    (``src/repro/core/exchange.py:284``), batched over the machines the
    tape's rows hold: machine g sits at (g // t2, g % t2) of the (t1,
    t2) grid.  Group j's
    segment is the flat segments [j*t2, (j+1)*t2), so a machine sends
    one contiguous segment a group, of up to C1 = ceil(cap_factor*m/t1)
    objects.  A machine merges the t1 rows it receives and cuts the
    merged row against its own group's t2-1 interior boundaries -- a
    query row of its own, so the search takes (t, t2-1) queries -- then
    sends tiles of C2 = ceil(cap_factor*m/t2) slots (rounded up to a
    multiple of ``overlap_chunks``) over i2.
    """
    grid = (t1, t2)
    c1, c2 = _staged_pair_capacities(m, t1, t2, cap_factor, overlap_chunks)
    dev = starts.device
    rows = starts.shape[0]
    local = torch.arange(rows, device=dev)
    me = tape.axis_index(rows, dev)
    i1, i2 = me // t2, me % t2
    g_starts = starts[:, ::t2]                                  # (rows, t1)
    g_ends = torch.cat([starts[:, t2::t2],
                        torch.full((rows, 1), m, dtype=starts.dtype,
                                   device=dev)], dim=1)
    g_lens = g_ends - g_starts
    kbuf1, vbuf1, drop1 = build_send_buffer(x_sorted, g_starts, g_lens, c1,
                                            values, valid_len=valid_len)
    sent1 = m - g_lens[local, i1]
    mine = interior[(i1 * t2)[:, None]
                    + torch.arange(t2 - 1, device=dev)]         # (rows, t2-1)
    aux = {}

    def restage(rk, rv):
        # merge the t1 landed rows, re-cut by my group's boundaries with
        # the flat partition's side='left' rule, clamped to the merged
        # row's real keys, as the reference's valid_len=count1
        merged, merged_v = _merge(rk, rv)
        count1 = (merged < PAD).sum(dim=1).to(torch.int32)
        cuts = torch.minimum(ops.searchsorted(merged, mine, side="left"),
                             count1[:, None])
        s2_starts = torch.cat([torch.zeros_like(cuts[:, :1]), cuts], dim=1)
        s2_lens = torch.cat([cuts, count1[:, None]], dim=1) - s2_starts
        kbuf2, vbuf2, aux["drop2"] = build_send_buffer(
            merged, s2_starts, s2_lens, c2, merged_v, valid_len=count1)
        return kbuf2, vbuf2, count1 - s2_lens[local, i2]

    outs, sent2 = tape.staged_all_to_all(
        kbuf1, grid=grid, values_buf=vbuf1, sent=sent1, pad=PAD,
        restage=restage, chunks=overlap_chunks,
        chunk_fn=_merge, phase_prefix=phase_prefix)
    if len(outs) == 1:
        final_k, final_v = outs[0]
    else:       # the chunks' merged runs, merged across the chunks
        final_k, final_v = _merge(
            torch.stack([ck for ck, _ in outs], dim=1),
            None if values is None else torch.stack([cv for _, cv in outs],
                                                    dim=1))
    count = (final_k < PAD).sum(dim=1).to(torch.int32)
    dropped = tape.psum(drop1 + aux["drop2"]).to(torch.int32)
    return ExchangeResult(final_k, final_v, count, sent1 + sent2, dropped)


class ExchangeResult(NamedTuple):
    keys: torch.Tensor      # (t, capacity) sorted ascending, pads last
    values: Optional[torch.Tensor]
    count: torch.Tensor     # (t,) valid objects received per machine
    sent: torch.Tensor      # (t,) objects sent to other machines
    dropped: torch.Tensor   # global dropped count (scalar)


def exchange_sorted_segments(x_sorted: torch.Tensor, interior: torch.Tensor,
                             *, t: int, cap_factor: float,
                             values: Optional[torch.Tensor] = None,
                             valid_len: Optional[int] = None,
                             sort_input: bool = False,
                             backend: str = "static",
                             tape: Optional[CollectiveTape] = None,
                             staged_shape: Optional[Tuple[int, int]] = None,
                             overlap_chunks: int = 2,
                             phase_prefix: str = "shuffle"
                             ) -> ExchangeResult:
    """Round-3 shuffle: deliver bucket k of every machine to machine k.

    x_sorted: (t, n) locally sorted rows (``valid_len`` real keys each
    when pre-padded); values: (t, n, ...) aligned with them, or None;
    interior: (t-1,) boundaries.  ``sort_input=True`` takes unsorted,
    unpadded rows and sorts and cuts them in one kernel
    (``ops.sort_partition[_kv]``), as Terasort's Round 3 does; it
    cannot be combined with ``valid_len``.  Each machine's capacity is
    ``flat_receive_capacity(m, t, cap_factor)``; every sender's tile row
    lands sorted, so the landed rows are merged (the reference's
    ``merge=True``) rather than sorted -- with values, by the stable
    argsort merge.

    ``staged_shape=(t1, t2)`` runs the two-level staged exchange over a
    (t1, t2) grid of the machines (:func:`_staged_exchange`); its stages
    record into their own phases (``"<phase_prefix> s1"`` / ``"s2"``),
    so a staged caller must not wrap the call in a phase of its own.
    The keys come out bitwise the flat path's.

    ``backend="ragged"`` sends exact-size segments
    (:func:`ragged_exchange`, a process group's only) into the same
    capacity and re-sorts the landed buffer (``ops.sort`` /
    ``ops.sort_kv``: the sender runs land at offsets that depend on the
    data); nothing drops, so ``dropped`` is 0.  The stable sort keeps
    equal keys in sender order, as the static merge does.
    """
    if backend not in ("static", "ragged"):
        raise ValueError(f"unknown exchange backend {backend!r}; "
                         "expected 'static' or 'ragged'")
    if sort_input and valid_len is not None:
        raise ValueError("sort_input=True takes unpadded input; "
                         "valid_len cannot be combined with it")
    if staged_shape is not None:
        t1, t2 = int(staged_shape[0]), int(staged_shape[1])
        if t1 * t2 != t or min(t1, t2) < 2:
            raise ValueError(f"staged_shape {staged_shape} must factor "
                             f"t={t} with both sub-axes >= 2")
        if backend != "static":
            raise NotImplementedError(
                "staged exchange supports the static backend only")
    tape = tape if tape is not None else CollectiveTape()
    m = valid_len if valid_len is not None else x_sorted.shape[1]
    cap_pair = flat_receive_capacity(m, t, cap_factor) // t
    with obs_trace.span("round3.pack"):
        if sort_input and values is not None:
            x_sorted, values, starts, lens = ops.sort_partition_kv(
                x_sorted, values, interior)
        elif sort_input:
            x_sorted, starts, lens = ops.sort_partition(x_sorted, interior)
        else:
            starts, lens = partition_sorted(x_sorted, interior,
                                            valid_len=valid_len)
        if staged_shape is None:
            rows = lens.shape[0]
            me = tape.axis_index(rows, lens.device)
            sent = m - lens[torch.arange(rows, device=lens.device),
                            me]                                 # leaving
            if backend == "static":
                keys_buf, vals_buf, local_drop = build_send_buffer(
                    x_sorted, starts, lens, cap_pair, values,
                    valid_len=valid_len)
    if staged_shape is not None:
        return _staged_exchange(
            x_sorted, interior, starts, lens, t1=t1, t2=t2, m=m,
            cap_factor=cap_factor, values=values, valid_len=valid_len,
            overlap_chunks=overlap_chunks, tape=tape,
            phase_prefix=phase_prefix)
    if backend == "ragged":
        if valid_len is not None:       # exact-size sends: no pad tail
            x_sorted = x_sorted[:, :m]
            values = None if values is None else values[:, :m]
        with obs_trace.span("round3.all_to_all"):
            recv, recv_v, count = ragged_exchange(
                x_sorted, starts, lens, cap_pair * t, tape, values=values,
                sent=sent)
        dropped = torch.zeros((), dtype=torch.int32, device=recv.device)
        with obs_trace.span("round3.merge"):
            if recv_v is None:
                keys, vals = ops.sort(recv), None
            else:
                keys, vals = ops.sort_kv(recv, recv_v)
        return ExchangeResult(keys, vals, count.to(torch.int32), sent,
                              dropped)
    with obs_trace.span("round3.all_to_all"):
        recv2d, recv_v2d = static_exchange(keys_buf, tape, sent,
                                           vals_buf)        # (rows, t, C)
        count = (recv2d.reshape(rows, -1) < PAD).sum(dim=1).to(torch.int32)
        dropped = tape.psum(local_drop).to(torch.int32)
    # pads (= inf) land last
    with obs_trace.span("round3.merge"):
        if recv_v2d is None:
            merged, merged_v = ops.merge_sorted_rows(recv2d), None
        else:
            merged, merged_v = ops.merge_sorted_rows_kv(recv2d, recv_v2d)
    return ExchangeResult(merged, merged_v, count, sent, dropped)


class RoutedRows(NamedTuple):
    """Landed state of :func:`exchange_routed_rows`: what the receivers
    need to unpack the tiles, and what the senders need to invert the
    routing for the return trip.  Machine axis first throughout."""
    recv_keys: torch.Tensor     # (t, t, cap_pair) owner keys; PAD = empty
    recv_payload: torch.Tensor  # (t, t, cap_pair, w) rows, zeros on pads
    perm: torch.Tensor          # (t, n) stable argsort of owner (send order)
    dest_sorted: torch.Tensor   # (t, n) int32 destination of each sorted row
    starts: torch.Tensor        # (t, t) first sorted row addressed to dest k
    lens: torch.Tensor          # (t, t) rows addressed to dest k
    cap_pair: int               # per-(src, dst) tile capacity
    local_drop: torch.Tensor    # (t,) rows dropped at send (pair overflow)


def exchange_routed_rows(owner: torch.Tensor, payload: torch.Tensor, *,
                         t: int, cap_pair: int,
                         tape: Optional[CollectiveTape] = None) -> RoutedRows:
    """Deliver payload row i of each machine to machine ``owner[i]``
    through the flat static exchange.

    owner: (t, n) int destinations in [0, t); payload: (t, n, w) rows.
    Each machine's rows are stably sorted by owner as float32 keys with
    their positions as values (``ops.sort_kv``: the pair sort, or the
    radix sort's order), cut at 1..t-1 (``partition_sorted``), packed
    into a (t, cap_pair) tile and exchanged.  Rows past a pair's
    capacity are counted in ``local_drop``; the caller's capacity retry
    recovers, as for the sort shuffles.  The staged topology is not
    offered: payload rows do not merge.
    """
    tape = tape if tape is not None else CollectiveTape()
    n_rows, n = owner.shape
    dev = owner.device
    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(n_rows, n)
    owner_sorted, perm = ops.sort_kv(owner.float().contiguous(), iota)
    rows = torch.arange(n_rows, device=dev)[:, None]
    pay_sorted = payload[rows, perm.long()]
    interior = torch.arange(1, t, dtype=torch.float32, device=dev)
    starts, lens = partition_sorted(owner_sorted, interior)
    keys_buf, vals_buf, local_drop = build_send_buffer(
        owner_sorted, starts, lens, cap_pair, pay_sorted)
    me = tape.axis_index(n_rows, dev)
    recv_k, recv_v = static_exchange(keys_buf, tape, n - lens[rows[:, 0], me],
                                     vals_buf)
    return RoutedRows(recv_k, recv_v, perm, owner_sorted.to(torch.int32),
                      starts, lens, cap_pair, local_drop)


def return_routed_rows(back_tiles: torch.Tensor, routed: RoutedRows, *,
                       tape: Optional[CollectiveTape] = None, sent=None,
                       received=None) -> torch.Tensor:
    """Invert :func:`exchange_routed_rows`: ship processed rows home.

    back_tiles: (t, t, cap_pair, w_out), tile [j, i] on machine j the
    processed rows machine i landed there, in landed order.  The
    all-to-all of them lands tile i on i in the (dst, col) layout i
    packed, so each sender finds its rows where it put them; rows that
    overflowed a pair tile on the way out come back as zeros.  Returns
    (t, n, w_out) rows in each machine's original (pre-sort) order.
    ``sent`` / ``received`` (t,) feed the tape: the tiles are dense
    payload with no sentinel, so the caller gives the true counts.
    """
    tape = tape if tape is not None else CollectiveTape()
    ret = tape.all_to_all(back_tiles, sent=sent, received=received)
    t, n = routed.perm.shape
    dev = ret.device
    rows = torch.arange(t, device=dev)[:, None]
    dest = routed.dest_sorted.long()
    offset = (torch.arange(n, dtype=torch.int32, device=dev)
              - torch.gather(routed.starts, 1, dest))
    ok = offset < routed.cap_pair
    safe = offset.clamp(0, routed.cap_pair - 1).long()
    got = ret[rows, dest, safe]                          # (t, n, w_out)
    got = torch.where(ok[..., None], got, torch.zeros((), dtype=ret.dtype,
                                                      device=dev))
    out = torch.zeros_like(got)
    out[rows, routed.perm.long()] = got
    return out
