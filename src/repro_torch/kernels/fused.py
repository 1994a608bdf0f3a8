"""Rank merge: the Round-3 receive merge past one tile.

Counterpart of the rank-merge half of ``src/repro/kernels/fused.py``
(``merge_ranks`` with ``_bin_search_pairs_block`` and
``_bin_search_pairs_bounded``).  The kernel is ``csrc/merge_ranks.cu``;
:func:`merge_ranks_plain` is its plain version, the same lexicographic
binary searches in torch ops, summed over the bound rows.  A CUDA
tensor launches the kernel, a CPU tensor runs the plain version.
``fused.sort_partition[_kv]`` are not on this slice's path and are not
ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda
from .bitonic import KEY_DTYPES, _SUFFIX, ftz, sort_sentinel

__all__ = ["merge_ranks", "merge_ranks_plain"]


def _steps(n: int) -> int:
    return max(1, math.ceil(math.log2(n + 1)))


def _bin_search_pairs_block(qk, qi, bk, bi, n_bounds: int) -> torch.Tensor:
    """Count pairs (bk, bi) lexicographically < (qk, qi), per query.

    qk/qi: (B, q) query keys (already ``ftz``-folded) and ids; bk/bi:
    (B, P) one bound row per batch entry, strictly increasing pairs.
    """
    lo = torch.zeros(qk.shape, dtype=torch.int32, device=qk.device)
    hi = torch.full(qk.shape, n_bounds, dtype=torch.int32, device=qk.device)
    for _ in range(_steps(n_bounds)):
        mid = torch.clamp_max((lo + hi) // 2, n_bounds - 1).long()
        k_mid = torch.gather(bk, 1, mid)
        i_mid = torch.gather(bi, 1, mid)
        pred = (k_mid < qk) | ((k_mid == qk) & (i_mid < qi))
        go_right = pred & (lo < hi)
        lo = torch.where(go_right, mid.int() + 1, lo)
        hi = torch.where(go_right, hi, mid.int())
        hi = torch.maximum(hi, lo)
    return lo


def _bin_search_pairs_bounded(qk, qi, bk, bi, n_valid: int,
                              steps: int) -> torch.Tensor:
    """Count pairs in ONE bound block (B, bb) lexicographically < each
    query; ``n_valid`` of its slots are real."""
    width = bk.shape[-1]
    lo = torch.zeros(qk.shape, dtype=torch.int32, device=qk.device)
    hi = torch.full(qk.shape, n_valid, dtype=torch.int32, device=qk.device)
    for _ in range(steps):
        mid = torch.clamp((lo + hi) // 2, 0, width - 1).long()
        k_mid = torch.gather(bk, 1, mid)
        i_mid = torch.gather(bi, 1, mid)
        pred = (k_mid < qk) | ((k_mid == qk) & (i_mid < qi))
        go_right = pred & (lo < hi)
        lo = torch.where(go_right, mid.int() + 1, lo)
        hi = torch.where(go_right, hi, mid.int())
        hi = torch.maximum(hi, lo)
    return lo


def _ranks_plain(keys, ids, c: int, bb: Optional[int]) -> torch.Tensor:
    """Plain version of the kernel: keys/ids (batch, t, w) -> (batch, t, w).

    The reference's sequential bound-row grid axis is the loop over k;
    its bound-block axis the loop over column blocks.
    """
    batch, t, w = keys.shape
    qk = ftz(keys).reshape(batch, t * w)
    qi = ids.reshape(batch, t * w)
    pos = torch.zeros((batch, t * w), dtype=torch.int32, device=keys.device)
    bk_all = ftz(keys)
    for k in range(t):
        bk, bi = bk_all[:, k], ids[:, k]
        if bb is None:
            pos += _bin_search_pairs_block(qk, qi, bk, bi, c)
            continue
        steps = _steps(bb)
        for base in range(0, w, bb):
            valid = min(max(c - base, 0), bb)
            pos += _bin_search_pairs_bounded(
                qk, qi, bk[:, base:base + bb], bi[:, base:base + bb],
                valid, steps)
    return pos.reshape(batch, t, w)


def _padded(keys, ids, bound_block):
    """Pad the width to a multiple of the bound block, as the reference
    does for direct callers; returns (keys, ids, c, bb)."""
    c = keys.shape[-1]
    bb = None if bound_block is None else min(int(bound_block), c)
    width = c if bb is None else -(-c // bb) * bb
    if width != c:
        keys = torch.nn.functional.pad(keys, (0, width - c),
                                       value=sort_sentinel(keys.dtype))
        ids = torch.nn.functional.pad(ids, (0, width - c),
                                      value=torch.iinfo(torch.int32).max)
    return keys, ids, c, bb


def merge_ranks_plain(keys: torch.Tensor, ids: torch.Tensor,
                      bound_block: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`merge_ranks`, on any device."""
    keys, ids, c, bb = _padded(keys, ids, bound_block)
    return _ranks_plain(keys, ids, c, bb)[:, :, :c]


def merge_ranks(keys: torch.Tensor, ids: torch.Tensor,
                bound_block: Optional[int] = None) -> torch.Tensor:
    """Global rank of every (key, id) pair.  keys/ids: (batch, t, c).

    Rows must be lexicographically increasing in (key, id).  Returns
    (batch, t, c) int32 positions: element (i, j)'s index in its batch
    entry's merged order, a permutation of [0, t*c).
    ``bound_block=None`` searches each bound row whole; an int searches
    it in column blocks of that width, as the reference's double-buffered
    variant does.  The ranks are bitwise the same either way.  A CUDA
    tensor runs the kernel, a CPU tensor :func:`merge_ranks_plain`.
    """
    if not keys.is_cuda:
        return merge_ranks_plain(keys, ids, bound_block)
    cuda.check_cuda_tensor("merge_ranks", keys, KEY_DTYPES)
    cuda.check_cuda_tensor("merge_ranks", ids, (torch.int32,))
    batch, t, _ = keys.shape
    keys, ids, c, bb = _padded(keys, ids, bound_block)
    width = keys.shape[-1]
    pos = torch.empty((batch, t, width), dtype=torch.int32,
                      device=keys.device)
    cuda.launch("merge_ranks", f"merge_ranks_{_SUFFIX[keys.dtype]}",
                keys.data_ptr(), ids.data_ptr(), pos.data_ptr(),
                batch, t, width, c, 0 if bb is None else bb)
    return pos[:, :, :c]
