"""Static-capacity local equi-join, batched over the t machines.

Counterpart of ``src/repro/core/localjoin.py`` (``local_equijoin`` :49,
``join_size`` :38).
Given each machine's fragments of S and T (int32 join keys and int32
payload row ids), emit every matching (s_row, t_row) pair into a fixed
number of output slots per machine: sort T by key (``ops.sort_kv``, the
pair-sort kernel), binary-search each S tuple's match range
(``ops.searchsorted`` left and right), and decode output slot j back to
(S tuple, offset) with a third search over the cumulative match counts.
No shape depends on the data.  All t machines run each step at once:
every tensor carries the machine axis first.

Masked tuples have key MASKED_KEY (int32 max) and never match.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops

__all__ = ["MASKED_KEY", "JoinOutput", "local_equijoin", "join_size"]

MASKED_KEY = torch.iinfo(torch.int32).max   # sentinel; real keys are below


class JoinOutput(NamedTuple):
    s_rows: torch.Tensor   # (t, capacity) payload of the S side (row ids)
    t_rows: torch.Tensor   # (t, capacity) payload of the T side
    valid: torch.Tensor    # (t, capacity) bool
    count: torch.Tensor    # (t,) int32: true number of result tuples
    dropped: torch.Tensor  # (t,) int32: results beyond capacity (0 == ok)


def join_size(s_keys: torch.Tensor, t_keys: torch.Tensor) -> torch.Tensor:
    """Exact |S >< T| of the fragments s_keys, t_keys (int32, (n,) each,
    or (t, n) machines summed), for capacity planning: T's keys sorted
    (``ops.sort``), each S key's match range by two searches, masked S
    keys counted 0.  An int64 0-d tensor on the keys' device."""
    tk = ops.sort(t_keys)
    lo = ops.searchsorted(tk, s_keys, side="left")
    hi = ops.searchsorted(tk, s_keys, side="right")
    return torch.where(s_keys == MASKED_KEY, 0, hi - lo).sum()


def local_equijoin(s_keys: torch.Tensor, s_rows: torch.Tensor,
                   t_keys: torch.Tensor, t_rows: torch.Tensor,
                   capacity: int) -> JoinOutput:
    """Cross product of equal keys on every machine, statically shaped.

    s_keys/s_rows: (t, ns); t_keys/t_rows: (t, nt); int32 keys
    (MASKED_KEY = absent) and int32 row ids aligned with them.
    """
    ns, nt = s_keys.shape[1], t_keys.shape[1]

    # Sort T by key; masked tuples (int32 max) sort to the end and no
    # search for a real key reaches them.
    tk, tv = ops.sort_kv(t_keys, t_rows)

    lo = ops.searchsorted(tk, s_keys, side="left")             # (t, ns)
    hi = ops.searchsorted(tk, s_keys, side="right")
    cnt = torch.where(s_keys == MASKED_KEY, 0, hi - lo)        # int32

    cum = torch.cumsum(cnt, dim=1, dtype=torch.int32)          # inclusive
    total = cum[:, -1]
    excl = cum - cnt                                           # exclusive

    out_j = torch.arange(capacity, dtype=torch.int32, device=s_keys.device)
    # slot j belongs to the S tuple whose [excl, cum) window holds j
    src_s = ops.searchsorted(cum, out_j, side="right")         # (t, cap)
    src_s = torch.clamp(src_s, 0, ns - 1).long()
    within = out_j - torch.gather(excl, 1, src_s)
    t_idx = torch.clamp(torch.gather(lo, 1, src_s) + within, 0, nt - 1)
    valid = out_j < total[:, None]
    zero = torch.zeros((), dtype=s_rows.dtype, device=s_rows.device)
    return JoinOutput(
        s_rows=torch.where(valid, torch.gather(s_rows, 1, src_s), zero),
        t_rows=torch.where(valid, torch.gather(tv, 1, t_idx.long()), zero),
        valid=valid,
        count=total,
        dropped=torch.clamp_min(total - capacity, 0),
    )
