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
  (key, id) order of t sorted rows as the reference computes it (its
  ``_bin_search_pairs_block`` and ``_bin_search_pairs_bounded``, summed
  over the bound rows, whole or in column blocks), and
  :func:`rank_merge` -- the reference's ``_rank_merge``: the merged keys
  and the stable flat order of the same rows with ids ``row * c +
  col``, what the dispatch's rank merge consumes; CUDA source
  ``csrc/merge_ranks.cu`` for both: a multiway merge (the ranks are the
  merged positions) for every entry, then a replay of the reference's
  searches (and, for :func:`rank_merge`, of its padded scatter) over
  the entries whose keys hold a NaN, where the searches are not
  monotone and the merged order is not the reference's (ROADMAP C15).

The plain versions run the networks of ``bitonic.py`` and the searches
of ``bucketize.py`` in torch ops.  A CUDA tensor launches the kernel, a
CPU tensor runs the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda
from .bitonic import (KEY_DTYPES, _SUFFIX, _iota_rows, _key_bits,
                      _next_pow2, _pad_row, _padded_slots, _pair_operands,
                      _ptr, _scratch, as_bits, ftz, sort_network_block,
                      sort_network_block_kv)
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


# The reference's bound-row block (src/repro/kernels/ops.py:114): its
# _rank_merge searches each padded row in column blocks of this width
# where the padded row is wider.
RANK_MERGE_BOUND_BLOCK = 1 << 11


def _rank_merge_block(c: int) -> Optional[int]:
    """The bound block the reference's ``_rank_merge`` applies to rows of
    c keys: ``RANK_MERGE_BOUND_BLOCK`` where the padded row is wider,
    else None (whole rows)."""
    cp2 = max(2, _next_pow2(c))
    return RANK_MERGE_BOUND_BLOCK if cp2 > RANK_MERGE_BOUND_BLOCK else None


def _bin_search_pairs_bounded(qk, qi, bk, bi, n_valid,
                              steps: int) -> torch.Tensor:
    """Count pairs (bk, bi) lexicographically < (qk, qi), per query: the
    reference's ``_bin_search_pairs_bounded`` (and, with ``n_valid`` the
    whole width, ``_bin_search_pairs_block``).

    qk/qi: (B, q) query keys (already ``ftz``-folded) and ids; bk/bi:
    (B, P) one bound block per batch entry; n_valid: (B, 1) the block's
    real slots.  ``steps`` fixed halvings with the ``lo < hi`` guard, mid
    clamped into the block.
    """
    lo = torch.zeros(qk.shape, dtype=torch.int32, device=qk.device)
    hi = n_valid.to(torch.int32).expand(qk.shape)
    width = bk.shape[-1]
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


# Queries times bound blocks that one step of the plain version searches
# at once (the searches of several bound blocks share a step when the
# queries are few).
_PLAIN_SEARCH_ELEMS = 1 << 22


def _ranks_plain(keys, ids, bound_block: Optional[int]) -> torch.Tensor:
    """Plain version of the kernel: keys/ids (batch, t, c) -> (batch, t, c).

    Each pair's rank is the sum over the t bound rows of the reference's
    fixed-step search: over the whole row (``bound_block=None``,
    ``_rank_kernel``), or over each column block of ``bound_block``
    slots apart (``_rank_kernel_blocked``: ``valid = clip(c - blk * bb,
    0, bb)``).  Where every row's pairs increase (no NaN key) each count
    is exact and the two agree; on a row that holds a NaN the searches
    are not monotone, and the block sums differ from the whole-row
    search.  The reference's sequential bound-row grid axis is the loop
    over k, ``ch`` bound blocks a step.
    """
    batch, t, c = keys.shape
    bb = c if bound_block is None else min(int(bound_block), c)
    nb = -(-c // bb)
    folded = ftz(keys)
    bk_all, bi_all = folded, ids
    if nb * bb != c:                  # slots past c are never probed
        bk_all = torch.nn.functional.pad(bk_all, (0, nb * bb - c))
        bi_all = torch.nn.functional.pad(bi_all, (0, nb * bb - c))
    # the (row, block) pairs as bound rows of bb slots
    bk_all = bk_all.reshape(batch, t * nb, bb)
    bi_all = bi_all.reshape(batch, t * nb, bb)
    blocks = t * nb
    valid = (c - torch.arange(nb, device=keys.device) * bb).clamp(0, bb)
    valid = valid.repeat(t)
    nq = t * c
    ch = max(1, min(blocks, _PLAIN_SEARCH_ELEMS // max(1, batch * nq)))
    qk = folded.reshape(batch, 1, nq)
    qi = ids.reshape(batch, 1, nq)
    pos = torch.zeros((batch, nq), dtype=torch.int32, device=keys.device)
    for k0 in range(0, blocks, ch):
        rows = min(ch, blocks - k0)
        # (batch * rows) searches: each bound block against all queries
        q_k = qk.expand(batch, rows, nq).reshape(batch * rows, nq)
        q_i = qi.expand(batch, rows, nq).reshape(batch * rows, nq)
        bk = bk_all[:, k0:k0 + rows].reshape(batch * rows, bb)
        bi = bi_all[:, k0:k0 + rows].reshape(batch * rows, bb)
        n_valid = valid[k0:k0 + rows].repeat(batch)[:, None]
        found = _bin_search_pairs_bounded(q_k, q_i, bk, bi, n_valid,
                                          _steps(bb))
        pos += found.reshape(batch, rows, nq).sum(dim=1, dtype=torch.int32)
    return pos.reshape(batch, t, c)


def merge_ranks_plain(keys: torch.Tensor, ids: torch.Tensor,
                      bound_block: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`merge_ranks`, on any device."""
    return _ranks_plain(keys, ids, bound_block)


def _nan_entries(keys: torch.Tensor) -> torch.Tensor:
    """(batch,) bool: the batch entries whose keys hold a NaN."""
    if not keys.dtype.is_floating_point:
        return torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    return torch.isnan(keys).reshape(keys.shape[0], -1).any(dim=1)


def _launch_merge(keys: torch.Tensor, ids: Optional[torch.Tensor],
                  pos: Optional[torch.Tensor]):
    """One call of the merge kernel on (batch, t, c) rows, with its two
    ping-pong sides, its tile cuts and the entries' NaN flags allocated
    here.  Without ``ids`` the merged keys and the flat order land in
    side 0, which is returned (side 1 is freed on return); with ``ids``
    the ranks land in ``pos`` and the sides (an id channel too) are
    scratch.  Returns (keys, order, flags): flags (batch + 1,) int32,
    nonzero where the entry's keys hold a NaN, then the replay's grid
    barrier counter (None for int32 keys, which hold no NaN).
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
    flags = (None if keys.dtype == torch.int32 else
             torch.empty((batch + 1,), dtype=torch.int32,
                         device=keys.device))

    def ptr(x):
        return None if x is None else x.data_ptr()

    cuda.launch("merge_ranks", f"merge_ranks_{_SUFFIX[keys.dtype]}",
                keys.data_ptr(), ptr(ids), k[0].data_ptr(),
                src[0].data_ptr(), ptr(tie[0]), k[1].data_ptr(),
                src[1].data_ptr(), ptr(tie[1]), ptr(pos), cuts.data_ptr(),
                ptr(flags), batch, t, c)
    return k[0], src[0], flags


def _launch_replay(keys, ids, flags, merged, order, pos,
                   bound_block: Optional[int]) -> None:
    """The reference's ranks on the entries ``flags`` marks (those whose
    keys hold a NaN), over what the merge kernel wrote: with ``ids`` the
    ranks into ``pos``; without, the padded entry's ranks and its
    last-wins scatter into ``merged`` and ``order``.  One C call, one
    cooperative launch, which returns at once where no entry is
    flagged."""
    if flags is None:                    # int32 keys: no NaN to replay
        return
    batch, t, c = keys.shape

    def ptr(x):
        return None if x is None else x.data_ptr()

    cuda.launch("merge_ranks_replay",
                f"merge_ranks_replay_{_SUFFIX[keys.dtype]}",
                keys.data_ptr(), ptr(ids), flags.data_ptr(), ptr(merged),
                ptr(order), ptr(pos), batch, t, c, bound_block or 0)


def merge_ranks(keys: torch.Tensor, ids: torch.Tensor,
                bound_block: Optional[int] = None) -> torch.Tensor:
    """Global rank of every (key, id) pair.  keys/ids: (batch, t, c).

    Rows must be lexicographically increasing in (key, id).  Returns
    (batch, t, c) int32 positions: the reference's ranks, the sum over
    the t bound rows of its fixed-step search, over the whole row
    (``bound_block=None``) or over each column block of ``bound_block``
    slots.  Where no key of an entry is NaN these are the pair's index
    in the entry's merged order, a permutation of [0, t*c), whichever
    the blocking.  On an entry that holds a NaN the searches are not
    monotone: ranks may collide, and the blocked sums differ from the
    whole-row search; the result is the reference's either way.  A CUDA
    tensor runs the merge kernel (its ranks are the merged positions),
    then the replay kernel over the entries that hold a NaN, both
    routed on the card with no host sync; a CPU tensor
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
    _, _, flags = _launch_merge(keys, ids, pos)
    _launch_replay(keys, ids, flags, None, None, pos, bound_block)
    return pos


def _merge_exact(keys: torch.Tensor):
    """Rows whose keys hold no NaN: the ranks of the unpadded (key, flat
    index) pairs are their merged positions, a permutation; the keys and
    the flat indices scattered to them."""
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


def _merge_replay(keys: torch.Tensor):
    """The reference's ``_rank_merge`` step for step, for rows that hold
    a NaN: the entry padded to (pow2 t, pow2 c) with the sort sentinel
    and unique pad ids, every padded pair ranked (blocked as the
    reference blocks it), then JAX's scatter into zeros -- where ranks
    collide the last source in flat order wins, a rank past the buffer
    is dropped, a place no rank names keeps key 0 and id 0 -- and the
    first t*c places kept."""
    batch, t, c = keys.shape
    kp, ip, cp2 = _padded_slots(keys)
    n = kp.shape[1]
    pos = _ranks_plain(kp.reshape(batch, n // cp2, cp2),
                       ip.reshape(1, n // cp2, cp2).expand(
                           batch, n // cp2, cp2).contiguous(),
                       _rank_merge_block(c)).reshape(batch, n)
    winner = torch.full((batch, n + 1), -1, dtype=torch.int64,
                        device=keys.device)
    src = torch.arange(n, device=keys.device).expand(batch, n)
    winner.scatter_reduce_(1, pos.long().clamp_max(n), src, "amax")
    winner = winner[:, :t * c]
    hit = winner >= 0
    take = winner.clamp_min(0)
    bits = _key_bits(kp)
    merged = torch.where(hit, torch.gather(bits, 1, take),
                         torch.zeros((), dtype=bits.dtype,
                                     device=keys.device))
    order = torch.where(hit, ip[take], 0).to(torch.int32)
    return merged.view(keys.dtype), order


def rank_merge_plain(keys: torch.Tensor):
    """The plain version of :func:`rank_merge`, on any device.  Decides
    per batch entry on the host: :func:`_merge_exact` where its keys
    hold no NaN, :func:`_merge_replay` where they do."""
    batch, t, c = keys.shape
    nan = _nan_entries(keys)
    if not bool(nan.any()):
        return _merge_exact(keys)
    merged = torch.empty((batch, t * c), dtype=keys.dtype,
                         device=keys.device)
    order = torch.empty((batch, t * c), dtype=torch.int32,
                        device=keys.device)
    for part, route in ((~nan, _merge_exact), (nan, _merge_replay)):
        idx = torch.nonzero(part).reshape(-1)
        if idx.numel():
            m, o = route(_key_bits(keys)[idx].view(keys.dtype))
            _key_bits(merged)[idx] = _key_bits(m)
            order[idx] = o
    return merged, order


def rank_merge(keys: torch.Tensor):
    """Merge t sorted rows per batch entry.  keys: (batch, t, c).

    Returns (merged (batch, t*c), order (batch, t*c) int32): the
    reference's ``_rank_merge`` of each entry.  Where the entry's keys
    hold no NaN, the keys in the lexicographic (key, flat index) order
    and the flat indices ``row * c + col`` in that order, the stable
    flat argsort (the pads of the reference's padded rows rank above
    every real pair).  Where they hold a NaN, the reference's padded
    ranks and its scatter, collisions, pads and zeros included.  A CUDA
    tensor runs the merge kernel, which writes both in its last level
    and flags the entries that hold a NaN in its first, then (float32
    and bf16 keys) the replay kernel, which overwrites the flagged
    entries and returns at once on the others: no host sync.  A CPU
    tensor :func:`rank_merge_plain`.
    """
    if not keys.is_cuda:
        return rank_merge_plain(keys)
    cuda.check_cuda_tensor("rank_merge", keys, KEY_DTYPES)
    merged, order, flags = _launch_merge(keys, None, None)
    _launch_replay(keys, None, flags, merged, order, None,
                   _rank_merge_block(keys.shape[-1]))
    return merged, order
