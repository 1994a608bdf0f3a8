"""Broadcast (fragment-replicate) equi-join -- the small-table path.

Counterpart of ``src/repro/core/broadcastjoin.py``.  The small table is
all-gathered to every machine and the big one never moves: one
synchronized round (alpha = 1).  The big side is dealt round-robin
(machine i holds rows i, i+t, ...), so a contiguous run of hot-key
tuples spreads evenly.  Per-machine output is not theorem-bounded; the
front door pairs its default capacity with the capacity-retry loop.

On the card the gathered small side is one shared array, the operand
every machine's local join reads; it becomes a sorted searchsorted
operand (or, when T is the small side, a pair-sort row) of any width:
past 2^16 rows its sort takes the radix family.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..cluster.collectives import CollectiveTape
from ..cluster.substrate import default_pool
from .localjoin import MASKED_KEY, local_equijoin

__all__ = ["broadcast_join"]


def _broadcast_body(bk, br, sk, sr, *, tape: CollectiveTape, small_side,
                    out_capacity):
    with tape.phase("broadcast+join"):
        t = bk.shape[0]
        cnt = (sk != MASKED_KEY).sum(1)
        gk = tape.all_gather(sk, count=cnt).reshape(1, -1).expand(t, -1)
        gr = tape.all_gather(sr, track=False).reshape(1, -1).expand(t, -1)
        if small_side == "s":
            return local_equijoin(gk, gr, bk, br, out_capacity)
        return local_equijoin(bk, br, gk, gr, out_capacity)


def _deal_round_robin(keys: np.ndarray, rows: np.ndarray, t: int, device):
    """(n,) -> (t, ceil(n/t)): machine i holds rows i, i+t, i+2t, ..."""
    pad = (-len(keys)) % t
    k = np.concatenate([np.asarray(keys, np.int32),
                        np.full(pad, MASKED_KEY, np.int32)])
    r = np.concatenate([np.asarray(rows, np.int32), np.zeros(pad, np.int32)])
    return (torch.from_numpy(k.reshape(-1, t).T.copy()).to(device),
            torch.from_numpy(r.reshape(-1, t).T.copy()).to(device))


def broadcast_join(s_keys: np.ndarray, s_rows: np.ndarray,
                   t_keys: np.ndarray, t_rows: np.ndarray,
                   t_machines: int, out_capacity: int,
                   small_side: Optional[str] = None, device="cuda"):
    """All-gather the small table, join locally.  Returns (JoinOutput, report).

    small_side: "s" or "t" forces which table is replicated; default the
    shorter one (ties go to S).  Output pairs keep the (s_row, t_row)
    orientation whichever side was broadcast.
    """
    t = t_machines
    s_keys = np.asarray(s_keys, np.int32)
    t_keys = np.asarray(t_keys, np.int32)
    if small_side is None:
        small_side = "s" if len(s_keys) <= len(t_keys) else "t"
    if small_side not in ("s", "t"):
        raise ValueError(f"small_side must be 's' or 't', got {small_side!r}")
    s_side = _deal_round_robin(s_keys, np.asarray(s_rows), t, device)
    t_side = _deal_round_robin(t_keys, np.asarray(t_rows), t, device)
    (small_k, small_r), (big_k, big_r) = ((s_side, t_side) if small_side == "s"
                                          else (t_side, s_side))
    body = functools.partial(_broadcast_body, small_side=small_side,
                             out_capacity=out_capacity)
    out, tape = default_pool()(t).run(body, big_k, big_r, small_k, small_r)
    counts = out.count.cpu().numpy()
    n_in = len(s_keys) + len(t_keys)
    report = tape.report(
        algorithm=f"BroadcastJoin(small={small_side.upper()})", t=t,
        n_in=n_in, n_out=int(counts.sum()), workload=counts)
    return out, report
