"""Batched searchsorted: the Round-3 cut of SMMS.

Counterpart of ``src/repro/kernels/bucketize.py`` (``searchsorted``
with its ``_bin_search_block`` and ``_pad_bounds``).  The kernel is
``csrc/searchsorted.cu``; :func:`searchsorted_plain` is its plain
version, the same fixed-step branch-free binary search with the
``lo < hi`` guard (:func:`_bin_search_block`) in torch ops.  A CUDA
tensor launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import math

import torch

from . import cuda
from .bitonic import KEY_DTYPES, _SUFFIX, _next_pow2, ftz, sort_sentinel

__all__ = ["searchsorted", "searchsorted_plain"]


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
    (B, q).  A CUDA tensor runs the kernel (float32 or int32, both
    operands of one dtype); a CPU tensor runs the plain version.
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
