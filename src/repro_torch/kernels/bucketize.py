"""Batched searchsorted (the Round-3 cut of SMMS) and the fused
bucketize + histogram.

Counterpart of ``src/repro/kernels/bucketize.py`` (``searchsorted`` and
``bucketize_histogram`` with their ``_bin_search_block`` and
``_pad_bounds``).  Both kernels are in ``csrc/searchsorted.cu``;
:func:`searchsorted_plain` and :func:`bucketize_histogram_plain` are
their plain versions, the same fixed-step branch-free binary search
with the ``lo < hi`` guard (:func:`_bin_search_block`) in torch ops.  A
CUDA tensor launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import math

import torch

from . import cuda
from .bitonic import KEY_DTYPES, _SUFFIX, _next_pow2, ftz, sort_sentinel

__all__ = ["searchsorted", "searchsorted_plain", "bucketize_histogram",
           "bucketize_histogram_plain"]


def _steps(n_bounds: int) -> int:
    return max(1, math.ceil(math.log2(n_bounds + 1)))


def _bin_search_block(keys: torch.Tensor, bounds: torch.Tensor,
                      n_bounds: int, side: str) -> torch.Tensor:
    """#bounds <= key (side='right') or #bounds < key (side='left').

    keys: (B, q); bounds: (B, P) with P >= n_bounds (padding past
    n_bounds is never read).  Returns (B, q) int32.
    """
    keys = ftz(keys)
    bounds = ftz(bounds)
    lo = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    hi = torch.full(keys.shape, n_bounds, dtype=torch.int32,
                    device=keys.device)
    for _ in range(_steps(n_bounds)):
        mid = torch.clamp_max((lo + hi) // 2, n_bounds - 1)
        b_mid = torch.gather(bounds, 1, mid.long())
        pred = (b_mid <= keys) if side == "right" else (b_mid < keys)
        go_right = pred & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
        hi = torch.maximum(hi, lo)
    return lo


def _pad_bounds(boundaries: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B, P) with P a power of two, sentinel-padded."""
    n = boundaries.shape[-1]
    p = max(2, _next_pow2(n))
    return torch.nn.functional.pad(boundaries, (0, p - n),
                                   value=sort_sentinel(boundaries.dtype))


def searchsorted_plain(sorted_arr: torch.Tensor, queries: torch.Tensor,
                       side: str = "left") -> torch.Tensor:
    """The plain version of :func:`searchsorted`, on any device."""
    return _bin_search_block(queries, _pad_bounds(sorted_arr),
                             sorted_arr.shape[1], side)


def searchsorted(sorted_arr: torch.Tensor, queries: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """Row-wise ``searchsorted(sorted_arr[b], queries[b], side)``, int32.

    sorted_arr: (B, n) ascending rows (duplicates fine); queries:
    (B, q); any row width.  A CUDA tensor runs the kernel (float32,
    bfloat16 or int32, both operands of one dtype); a CPU tensor runs
    the plain version.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    batch, n = sorted_arr.shape
    nq = queries.shape[1]
    if queries.shape[0] != batch:
        raise ValueError(f"searchsorted: {batch} sorted rows but "
                         f"{queries.shape[0]} query rows")
    if not sorted_arr.is_cuda:
        return searchsorted_plain(sorted_arr, queries, side)
    cuda.check_cuda_tensor("searchsorted", sorted_arr, KEY_DTYPES)
    cuda.check_cuda_tensor("searchsorted", queries, (sorted_arr.dtype,))
    out = torch.empty((batch, nq), dtype=torch.int32,
                      device=sorted_arr.device)
    cuda.launch("searchsorted", f"searchsorted_{_SUFFIX[sorted_arr.dtype]}",
                sorted_arr.data_ptr(), queries.data_ptr(), out.data_ptr(),
                batch, n, nq, int(side == "right"), _steps(n))
    return out


def _single_bucket(keys: torch.Tensor):
    """t == 1: every key in bucket 0 (the reference returns before its
    kernel too)."""
    n = keys.shape[0]
    return (torch.zeros((n,), dtype=torch.int32, device=keys.device),
            torch.full((1,), n, dtype=torch.int32, device=keys.device))


def _check_buckets(keys: torch.Tensor, boundaries: torch.Tensor,
                   t: int) -> None:
    if keys.dim() != 1 or boundaries.dim() != 1:
        raise ValueError(f"bucketize_histogram: keys (n,) and boundaries "
                         f"(t-1,) expected, got {tuple(keys.shape)} and "
                         f"{tuple(boundaries.shape)}")
    if boundaries.shape[0] != t - 1:
        raise ValueError(f"bucketize_histogram: {boundaries.shape[0]} "
                         f"boundaries for t = {t} buckets (want t - 1)")


def bucketize_histogram_plain(keys: torch.Tensor, boundaries: torch.Tensor,
                              t: int):
    """The plain version of :func:`bucketize_histogram`, on any device."""
    _check_buckets(keys, boundaries, t)
    if t == 1:
        return _single_bucket(keys)
    ids = _bin_search_block(keys[None], _pad_bounds(boundaries[None]),
                            t - 1, "right")[0]
    counts = torch.bincount(ids.long(), minlength=t).to(torch.int32)
    return ids, counts


def bucketize_histogram(keys: torch.Tensor, boundaries: torch.Tensor,
                        t: int):
    """keys (n,), boundaries (t-1,) ascending -> (ids (n,), counts (t,)).

    Buckets are [b_k, b_{k+1}): id = searchsorted(boundaries, key,
    'right') -- denormals compare as zero, a NaN key lands in bucket 0
    -- and counts[i] is the number of keys with id i, both int32.
    Duplicate boundaries leave their middle buckets empty; t need not
    be a power of two, nor below 2^16.  A CUDA tensor runs the kernel
    (float32, bfloat16 or int32, one dtype for both operands); a CPU
    tensor the plain version.
    """
    _check_buckets(keys, boundaries, t)
    if not keys.is_cuda:
        return bucketize_histogram_plain(keys, boundaries, t)
    cuda.check_cuda_tensor("bucketize_histogram", keys, KEY_DTYPES)
    cuda.check_cuda_tensor("bucketize_histogram", boundaries, (keys.dtype,))
    if t == 1:
        return _single_bucket(keys)
    n = keys.shape[0]
    ids = torch.empty((n,), dtype=torch.int32, device=keys.device)
    counts = torch.empty((t,), dtype=torch.int32, device=keys.device)
    cuda.launch("bucketize_histogram",
                f"bucketize_histogram_{_SUFFIX[keys.dtype]}",
                keys.data_ptr(), boundaries.data_ptr(), ids.data_ptr(),
                counts.data_ptr(), n, t, _steps(t - 1))
    return ids, counts
