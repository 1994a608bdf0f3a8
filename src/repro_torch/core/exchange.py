"""The Round-3 shuffle, flat static exchange, batched over the machines.

Counterpart of the flat static path of ``src/repro/core/exchange.py``.
Every machine cuts its locally sorted row at the t-1 interior
boundaries (or, with ``sort_input``, sorts and cuts it in one kernel,
as Terasort's Round 3 does), packs the t contiguous segments into a
(t, C) tile sentinel-padded to the capacity C that the sort's workload
theorem sizes, exchanges the tiles all-to-all and merges the t landed
sorted rows.  Values, when present, ride in a second tile (zeros in the
pad slots) through an untracked all-to-all and come out of the merge in
the keys' stable order.  Here all t machines do each step at once: rows, tiles and
landed buffers carry the machine axis first.

Dropped objects (a segment longer than C) are counted, not hidden: the
caller's capacity-retry loop re-runs with a larger factor.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..cluster.collectives import CollectiveTape
from ..kernels import ops

__all__ = ["PAD", "partition_sorted", "build_send_buffer", "static_exchange",
           "flat_receive_capacity", "ExchangeResult",
           "exchange_sorted_segments"]

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

    x_sorted: (t, n); starts/lens: (t, t); values: (t, n, ...) or None.
    Returns (keys_buf (t, t, C), values_buf (t, t, C, ...) with zeros in
    the pad slots or None, dropped (t,)) where dropped counts each
    machine's objects beyond the per-pair capacity.
    """
    t = starts.shape[0]
    m = valid_len if valid_len is not None else x_sorted.shape[1]
    cols = torch.arange(cap_per_pair, dtype=torch.int32,
                        device=x_sorted.device)
    idx = starts[:, :, None] + cols                           # (t, t, C)
    valid = cols < lens[:, :, None]
    safe = torch.clamp(idx, 0, m - 1).long().reshape(t, -1)
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


def flat_receive_capacity(m: int, t: int, cap_factor: float) -> int:
    """Receive-buffer slots of the flat exchange: t * ceil-per-pair."""
    return int(-(-int(cap_factor * m) // t) * t)


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
                             tape: Optional[CollectiveTape] = None
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
    """
    if sort_input and valid_len is not None:
        raise ValueError("sort_input=True takes unpadded input; "
                         "valid_len cannot be combined with it")
    tape = tape if tape is not None else CollectiveTape()
    m = valid_len if valid_len is not None else x_sorted.shape[1]
    cap_pair = flat_receive_capacity(m, t, cap_factor) // t
    if sort_input and values is not None:
        x_sorted, values, starts, lens = ops.sort_partition_kv(
            x_sorted, values, interior)
    elif sort_input:
        x_sorted, starts, lens = ops.sort_partition(x_sorted, interior)
    else:
        starts, lens = partition_sorted(x_sorted, interior,
                                        valid_len=valid_len)
    me = torch.arange(t, device=lens.device)
    sent = m - lens[me, me]                      # objects leaving each machine
    keys_buf, vals_buf, local_drop = build_send_buffer(
        x_sorted, starts, lens, cap_pair, values, valid_len=valid_len)
    recv2d, recv_v2d = static_exchange(keys_buf, tape, sent,
                                       vals_buf)            # (t, t, C)
    count = (recv2d.reshape(t, -1) < PAD).sum(dim=1).to(torch.int32)
    dropped = tape.psum(local_drop).to(torch.int32)
    # pads (= inf) land last
    if recv_v2d is None:
        return ExchangeResult(ops.merge_sorted_rows(recv2d), None, count,
                              sent, dropped)
    merged, merged_v = ops.merge_sorted_rows_kv(recv2d, recv_v2d)
    return ExchangeResult(merged, merged_v, count, sent, dropped)
