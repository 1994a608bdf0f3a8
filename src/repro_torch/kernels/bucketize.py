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
from typing import Optional

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


def _search_shape(sorted_arr: torch.Tensor, queries: torch.Tensor):
    """Check a search's operands: (B, n) rows and (q,), (1, q) or (B, q)
    queries.  Returns (B, n, q, the queries' row stride: 0 for one row
    shared by every key row)."""
    batch, n = sorted_arr.shape
    if queries.dim() == 1:
        return batch, n, queries.shape[0], 0
    rows, nq = queries.shape
    if rows != batch and rows != 1:
        raise ValueError(f"searchsorted: {batch} sorted rows but queries "
                         f"{tuple(queries.shape)} (want (q,), (1, q) or "
                         f"({batch}, q))")
    return batch, n, nq, nq if rows > 1 else 0


def searchsorted_plain(sorted_arr: torch.Tensor, queries: torch.Tensor,
                       side: str = "left",
                       valid_len: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`searchsorted`, on any device."""
    batch, n, nq, _ = _search_shape(sorted_arr, queries)
    ids = _bin_search_block(queries.expand(batch, nq),
                            _pad_bounds(sorted_arr), n, side)
    return ids if valid_len is None else torch.clamp_max(ids, int(valid_len))


_SEARCH_ENTRY = {dtype: f"searchsorted_{suffix}"
                 for dtype, suffix in _SUFFIX.items()}


def searchsorted(sorted_arr: torch.Tensor, queries: torch.Tensor,
                 side: str = "left",
                 valid_len: Optional[int] = None) -> torch.Tensor:
    """Row-wise ``searchsorted(sorted_arr[b], queries[b], side)``, int32.

    sorted_arr: (B, n) ascending rows (duplicates fine), any width;
    queries: (B, q), or (1, q) or (q,) -- one query row searched in
    every row.
    ``valid_len=m`` clamps each result to m (the rows' real length when
    they carry a sentinel tail).  A CUDA tensor runs the kernel
    (float32, bfloat16 or int32, both operands of one dtype; a shared
    row is read in place through a row stride of 0, and the clamp is
    the kernel's); a CPU tensor runs the plain version.
    """
    if side != "left" and side != "right":
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    batch, n, nq, q_stride = _search_shape(sorted_arr, queries)
    if not sorted_arr.is_cuda:
        return searchsorted_plain(sorted_arr, queries, side, valid_len)
    cuda.check_cuda_tensor("searchsorted", sorted_arr, KEY_DTYPES)
    cuda.check_cuda_tensor("searchsorted", queries, (sorted_arr.dtype,))
    out = torch.empty((batch, nq), dtype=torch.int32,
                      device=sorted_arr.device)
    cuda.launch("searchsorted", _SEARCH_ENTRY[sorted_arr.dtype],
                sorted_arr.data_ptr(), queries.data_ptr(), out.data_ptr(),
                batch, n, nq, q_stride, side == "right",
                -1 if valid_len is None else int(valid_len))
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


# (device index, raw stream) -> (the histogram kernel's workspace, the
# largest t it serves): int32, the ticket the grid's last block takes
# and the grid's counts (the counts' size past 12,288 buckets, 48 KiB
# below), both zero between calls (the last block leaves them so).
# Made with zeros once, grown when a call asks for more buckets; calls
# on one stream run in order, so they share it.
_WORKSPACE: dict = {}


def _workspace(device: torch.device, t: int) -> torch.Tensor:
    key = cuda.stream_key()
    if device.index != key[0]:
        raise ValueError(f"bucketize_histogram: keys on {device} but the "
                         f"current device is cuda:{key[0]}")
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1] < t:
        ints = cuda.library("searchsorted").bucketize_histogram_workspace(t)
        ws = _WORKSPACE[key] = (torch.zeros((ints,), dtype=torch.int32,
                                            device=device), t)
    return ws[0]


def bucketize_histogram(keys: torch.Tensor, boundaries: torch.Tensor,
                        t: int):
    """keys (n,), boundaries (t-1,) ascending -> (ids (n,), counts (t,)).

    Buckets are [b_k, b_{k+1}): id = searchsorted(boundaries, key,
    'right') -- denormals compare as zero, a NaN key lands in bucket 0
    -- and counts[i] is the number of keys with id i, both int32.
    Duplicate boundaries leave their middle buckets empty; t need not
    be a power of two, nor below 2^16.  A CUDA tensor runs the kernel
    (float32, bfloat16 or int32, one dtype for both operands; keys may
    be a view at any offset): one launch a call, no memset; a CPU
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
                counts.data_ptr(), _workspace(keys.device, t).data_ptr(), n,
                t)
    return ids, counts
