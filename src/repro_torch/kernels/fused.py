"""Fused kernels: the sort-and-partition of Terasort's Round 3 and
RandJoin's routing, and the rank merge past one tile.

Counterpart of ``src/repro/kernels/fused.py``.  Three kernels, each
with its plain PyTorch version beside it:

* :func:`sort_partition` -- sort each row and left-search the row's
  queries over the sorted row in one pass; CUDA source
  ``csrc/sort_partition.cu``.
* :func:`sort_partition_kv` -- the (key, iota) pair sort (the stable
  argsort) with the same search.  Same source.
* :func:`merge_ranks` -- every element's rank in the lexicographic
  (key, flat id) order of t sorted rows (the reference's
  ``_bin_search_pairs_block`` and ``_bin_search_pairs_bounded``, summed
  over the bound rows; the plain version's whole-row search gives the
  blocked sums too); CUDA source ``csrc/merge_ranks.cu``.

The plain versions run the networks of ``bitonic.py`` and the searches
of ``bucketize.py`` in torch ops.  A CUDA tensor launches the kernel, a
CPU tensor runs the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda
from .bitonic import (KEY_DTYPES, _SUFFIX, _pad_row, ftz,
                      sort_network_block, sort_network_block_kv,
                      sort_sentinel)
from .bucketize import _bin_search_block

__all__ = ["sort_partition", "sort_partition_plain", "sort_partition_kv",
           "sort_partition_kv_plain", "merge_ranks", "merge_ranks_plain"]


def _check_queries(keys: torch.Tensor, queries: torch.Tensor) -> None:
    if queries.dim() != 2 or queries.shape[0] != keys.shape[0]:
        raise ValueError(f"sort_partition: {keys.shape[0]} key rows need "
                         f"one query row each, got {tuple(queries.shape)}")


def _iota_rows(rows: int, m: int, device) -> torch.Tensor:
    """(rows, pow2 >= 2) arange(m) padded with int32 max, as the
    reference pads it (src/repro/kernels/fused.py:111-112)."""
    iota = torch.arange(m, dtype=torch.int32, device=device)
    return _pad_row(iota.repeat(rows, 1))


def sort_partition_plain(x: torch.Tensor, queries: torch.Tensor):
    """The plain version of :func:`sort_partition`, on any device."""
    _check_queries(x, queries)
    m = x.shape[-1]
    xs = sort_network_block(_pad_row(x))
    return xs[:, :m], _bin_search_block(queries, xs, m, "left")


def sort_partition(x: torch.Tensor, queries: torch.Tensor):
    """Sort each row and left-search its queries over the sorted row.

    x: (rows, m) keys; queries: (rows, nq) ascending, one row per key
    row, of x's dtype.  Returns (xs (rows, m) ascending, cuts (rows, nq)
    int32) with ``cuts[r, i]`` the count of ``xs[r]`` comparing below
    ``queries[r, i]`` (denormals fold to zero): the sort and
    ``searchsorted(side="left")`` in one pass.  Rows are padded to a
    power of two with the sort sentinel, as the reference pads them.  A
    CUDA tensor runs the kernel, a CPU tensor
    :func:`sort_partition_plain`.
    """
    if not x.is_cuda:
        return sort_partition_plain(x, queries)
    _check_queries(x, queries)
    cuda.check_cuda_tensor("sort_partition", x, KEY_DTYPES)
    cuda.check_cuda_tensor("sort_partition", queries, (x.dtype,))
    rows, m = x.shape
    xs = _pad_row(x).clone(memory_format=torch.contiguous_format)
    cuts = torch.empty((rows, queries.shape[1]), dtype=torch.int32,
                       device=x.device)
    cuda.launch("sort_partition", f"sort_partition_{_SUFFIX[x.dtype]}",
                xs.data_ptr(), queries.data_ptr(), cuts.data_ptr(), rows,
                xs.shape[1], m, queries.shape[1])
    return xs[:, :m], cuts


def sort_partition_kv_plain(keys: torch.Tensor, queries: torch.Tensor):
    """The plain version of :func:`sort_partition_kv`, on any device."""
    _check_queries(keys, queries)
    rows, m = keys.shape
    ks, order = sort_network_block_kv(_pad_row(keys),
                                      _iota_rows(rows, m, keys.device))
    return ks[:, :m], order[:, :m], _bin_search_block(queries, ks, m, "left")


def sort_partition_kv(keys: torch.Tensor, queries: torch.Tensor):
    """Stable pair sort of each row and the same search as
    :func:`sort_partition`.

    keys: (rows, m); queries: (rows, nq).  Returns (keys sorted (rows,
    m), order (rows, m) int32, cuts (rows, nq) int32): ``order`` is the
    stable argsort, from the lexicographic (key, arange(m)) network.  A
    CUDA tensor runs the kernel, a CPU tensor
    :func:`sort_partition_kv_plain`.
    """
    if not keys.is_cuda:
        return sort_partition_kv_plain(keys, queries)
    _check_queries(keys, queries)
    cuda.check_cuda_tensor("sort_partition_kv", keys, KEY_DTYPES)
    cuda.check_cuda_tensor("sort_partition_kv", queries, (keys.dtype,))
    rows, m = keys.shape
    ks = _pad_row(keys).clone(memory_format=torch.contiguous_format)
    order = _iota_rows(rows, m, keys.device).contiguous()
    cuts = torch.empty((rows, queries.shape[1]), dtype=torch.int32,
                       device=keys.device)
    cuda.launch("sort_partition_kv",
                f"sort_partition_kv_{_SUFFIX[keys.dtype]}", ks.data_ptr(),
                order.data_ptr(), queries.data_ptr(), cuts.data_ptr(), rows,
                ks.shape[1], m, queries.shape[1])
    return ks[:, :m], order[:, :m], cuts


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


# Queries times bound rows that one step of the plain version searches
# at once (the searches of several bound rows share a step when the
# queries are few).
_PLAIN_SEARCH_ELEMS = 1 << 22


def _ranks_plain(keys, ids, c: int) -> torch.Tensor:
    """Plain version of the kernel: keys/ids (batch, t, w) -> (batch, t, w).

    The reference's sequential bound-row grid axis is the loop over k,
    ``ch`` bound rows a step.  Its blocked variant searches each column
    block [base, base + bb) of a bound row apart; the row is sorted, so
    a block holds clamp(n - base, 0, valid) of the n pairs below a query
    in the whole row, and the blocks' counts sum to n: one whole-row
    search gives the blocked result too.  Each count is exact, so the
    sum does not depend on ``ch``.
    """
    batch, t, w = keys.shape
    nq = t * w
    ch = max(1, min(t, _PLAIN_SEARCH_ELEMS // max(1, batch * nq)))
    qk = ftz(keys).reshape(batch, 1, nq)
    qi = ids.reshape(batch, 1, nq)
    pos = torch.zeros((batch, nq), dtype=torch.int32, device=keys.device)
    bk_all = ftz(keys)
    for k0 in range(0, t, ch):
        rows = min(ch, t - k0)
        # (batch * rows) searches: each bound row against all queries
        q_k = qk.expand(batch, rows, nq).reshape(batch * rows, nq)
        q_i = qi.expand(batch, rows, nq).reshape(batch * rows, nq)
        bk = bk_all[:, k0:k0 + rows].reshape(batch * rows, w)
        bi = ids[:, k0:k0 + rows].reshape(batch * rows, w)
        found = _bin_search_pairs_block(q_k, q_i, bk, bi, c)
        pos += found.reshape(batch, rows, nq).sum(dim=1, dtype=torch.int32)
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
    keys, ids, c, _ = _padded(keys, ids, bound_block)
    return _ranks_plain(keys, ids, c)[:, :, :c]


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
