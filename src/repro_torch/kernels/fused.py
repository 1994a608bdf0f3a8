"""Fused kernels: the sort-and-partition of Terasort's Round 3 and
RandJoin's routing, and the rank merge past one tile.

Counterpart of ``src/repro/kernels/fused.py``.  Three kernels, each
entry with its plain PyTorch version beside it:

* :func:`sort_partition` -- sort each row and left-search the row's
  queries over the sorted row in one launch; CUDA source
  ``csrc/sort_partition.cu``.
* :func:`sort_partition_kv` -- the (key, iota) pair sort (the stable
  argsort) with the same search.  Same source and schedule (the iota
  generated in the kernel).
* :func:`merge_ranks` -- every element's rank in the lexicographic
  (key, id) order of t sorted rows (the reference's
  ``_bin_search_pairs_block`` and ``_bin_search_pairs_bounded``, summed
  over the bound rows; the plain version's whole-row search gives the
  blocked sums too), and :func:`rank_merge` -- the merged keys and the
  stable flat order of the same rows with ids ``row * c + col``, what
  the dispatch's rank merge consumes; CUDA source ``csrc/merge_ranks.cu``
  for both (a multiway merge: the ranks are the merged positions).

The plain versions run the networks of ``bitonic.py`` and the searches
of ``bucketize.py`` in torch ops.  A CUDA tensor launches the kernel, a
CPU tensor runs the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda
from .bitonic import (KEY_DTYPES, _SUFFIX, _iota_rows, _pad_row,
                      _pair_operands, _ptr, _scratch, as_bits, ftz,
                      sort_network_block, sort_network_block_kv,
                      sort_sentinel)
from .bucketize import _bin_search_block

__all__ = ["sort_partition", "sort_partition_plain", "sort_partition_kv",
           "sort_partition_kv_plain", "merge_ranks", "merge_ranks_plain",
           "rank_merge", "rank_merge_plain"]


def _check_queries(keys: torch.Tensor, queries: torch.Tensor) -> None:
    if queries.dim() != 2 or queries.shape[0] != keys.shape[0]:
        raise ValueError(f"sort_partition: {keys.shape[0]} key rows need "
                         f"one query row each, got {tuple(queries.shape)}")


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
    CUDA tensor runs the kernel, which reads the rows unpadded and
    writes the keys and the cuts in one launch (up to
    ``bitonic.SORT_LAUNCH_LANES`` padded slots); a CPU tensor
    :func:`sort_partition_plain`.
    """
    if not x.is_cuda:
        return sort_partition_plain(x, queries)
    _check_queries(x, queries)
    x, queries = x.contiguous(), queries.contiguous()
    cuda.check_cuda_tensor("sort_partition", x, KEY_DTYPES)
    cuda.check_cuda_tensor("sort_partition", queries, (x.dtype,))
    rows, m = x.shape
    xs = torch.empty_like(x)
    cuts = torch.empty((rows, queries.shape[1]), dtype=torch.int32,
                       device=x.device)
    cuda.launch("sort_partition", f"sort_partition_{_SUFFIX[x.dtype]}",
                x.data_ptr(), queries.data_ptr(), xs.data_ptr(),
                cuts.data_ptr(), _ptr(_scratch(x)), rows, m,
                queries.shape[1])
    return xs, cuts


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
    CUDA tensor runs the kernel, which reads the rows unpadded,
    generates the order channel and writes the three outputs in one
    launch (up to ``bitonic.SORT_LAUNCH_LANES`` padded slots); a
    CPU tensor runs :func:`sort_partition_kv_plain`.
    """
    if not keys.is_cuda:
        return sort_partition_kv_plain(keys, queries)
    _check_queries(keys, queries)
    keys, queries = keys.contiguous(), queries.contiguous()
    cuda.check_cuda_tensor("sort_partition_kv", keys, KEY_DTYPES)
    cuda.check_cuda_tensor("sort_partition_kv", queries, (keys.dtype,))
    rows, m = keys.shape
    ks, order, (sk, sv) = _pair_operands(keys)
    cuts = torch.empty((rows, queries.shape[1]), dtype=torch.int32,
                       device=keys.device)
    cuda.launch("sort_partition_kv",
                f"sort_partition_kv_{_SUFFIX[keys.dtype]}", keys.data_ptr(),
                queries.data_ptr(), ks.data_ptr(), order.data_ptr(),
                cuts.data_ptr(), _ptr(sk), _ptr(sv), rows, m,
                queries.shape[1])
    return ks, order, cuts


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


def _launch_merge(keys: torch.Tensor, ids: Optional[torch.Tensor],
                  pos: Optional[torch.Tensor]):
    """One call of the merge kernel on (batch, t, c) rows, with its two
    ping-pong sides and its tile cuts allocated here.  Without ``ids``
    the merged keys and the flat order land in side 0, which is
    returned (side 1 is freed on return); with ``ids`` the ranks land in
    ``pos`` and the sides (an id channel too) are scratch.
    """
    batch, t, c = keys.shape

    def side(dtype):
        return torch.empty((batch, t * c), dtype=dtype, device=keys.device)

    k = [side(keys.dtype), side(keys.dtype)]
    src = [side(torch.int32), side(torch.int32)]
    tie = [None, None] if ids is None else [side(torch.int32),
                                            side(torch.int32)]
    # each level's tile boundaries, found before the level merges
    cuts = torch.empty(cuda.library("merge_ranks").merge_ranks_cuts(
        batch, t, c), dtype=torch.int32, device=keys.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    cuda.launch("merge_ranks", f"merge_ranks_{_SUFFIX[keys.dtype]}",
                keys.data_ptr(), ptr(ids), k[0].data_ptr(),
                src[0].data_ptr(), ptr(tie[0]), k[1].data_ptr(),
                src[1].data_ptr(), ptr(tie[1]), ptr(pos), cuts.data_ptr(),
                batch, t, c)
    return k[0], src[0]


def merge_ranks(keys: torch.Tensor, ids: torch.Tensor,
                bound_block: Optional[int] = None) -> torch.Tensor:
    """Global rank of every (key, id) pair.  keys/ids: (batch, t, c).

    Rows must be lexicographically increasing in (key, id).  Returns
    (batch, t, c) int32 positions: element (i, j)'s index in its batch
    entry's merged order, a permutation of [0, t*c).
    ``bound_block=None`` searches each bound row whole; an int searches
    it in column blocks of that width, as the reference's double-buffered
    variant does.  The ranks are bitwise the same either way.  A CUDA
    tensor runs the kernel, which merges the rows and ignores
    ``bound_block`` (ranks are additive over column blocks); a CPU tensor
    :func:`merge_ranks_plain`.
    """
    if not keys.is_cuda:
        return merge_ranks_plain(keys, ids, bound_block)
    cuda.check_cuda_tensor("merge_ranks", keys, KEY_DTYPES)
    cuda.check_cuda_tensor("merge_ranks", ids, (torch.int32,))
    if ids.shape != keys.shape:
        raise ValueError(f"merge_ranks: ids {tuple(ids.shape)} do not align "
                         f"with keys {tuple(keys.shape)}")
    pos = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    _launch_merge(keys, ids, pos)
    return pos


def rank_merge_plain(keys: torch.Tensor):
    """The plain version of :func:`rank_merge`, on any device: the ranks
    of the (key, flat index) pairs, then a scatter of the keys and of
    the flat indices to their ranks."""
    batch, t, c = keys.shape
    flat = torch.arange(t * c, dtype=torch.int32, device=keys.device)
    ids = flat.reshape(1, t, c).expand(batch, t, c).contiguous()
    pos = merge_ranks_plain(keys, ids).reshape(batch, -1).long()
    merged = torch.empty((batch, t * c), dtype=keys.dtype,
                         device=keys.device)
    as_bits(merged).scatter_(1, pos, as_bits(keys.reshape(batch, -1)))
    order = torch.empty((batch, t * c), dtype=torch.int32,
                        device=keys.device)
    order.scatter_(1, pos, ids.reshape(batch, -1))
    return merged, order


def rank_merge(keys: torch.Tensor):
    """Merge t sorted rows per batch entry.  keys: (batch, t, c).

    Returns (merged (batch, t*c), order (batch, t*c) int32): the keys in
    the lexicographic (key, flat index) order and the flat indices
    ``row * c + col`` in that order, which are the stable flat argsort.
    A CUDA tensor runs the merge kernel, which writes both in its last
    level; a CPU tensor :func:`rank_merge_plain`.
    """
    if not keys.is_cuda:
        return rank_merge_plain(keys)
    cuda.check_cuda_tensor("rank_merge", keys, KEY_DTYPES)
    return _launch_merge(keys, None, None)
