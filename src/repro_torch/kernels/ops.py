"""Kernel dispatch for the port: the single entry the cluster code calls.

Counterpart of ``src/repro/kernels/ops.py`` for SMMS with and without
values, Terasort, RandJoin's routing and the local equi-join
(``sort``, ``sort_kv``, ``searchsorted``, ``sort_partition``,
``sort_partition_kv``, ``merge_sorted_rows``, ``merge_sorted_rows_kv``).
The reference picks between a Pallas backend and a jnp backend and
falls back to jnp for operands a kernel cannot take.  The port has no
backend switch and no fallback:

* which implementation runs is decided by the operand's device alone --
  a CUDA tensor launches the hand-written kernel, a CPU tensor runs the
  kernel's plain PyTorch version (the same network or search in torch
  ops, which is how the tests hold the port against the reference);
* an operand outside the kernels' gate (:func:`kernel_eligible`: dtype,
  rank, row width) raises on either device, so a CUDA run can never
  end up in a library sort.

All operands carry the machine axis first: a (t, m) array is t
machines' rows, and every call handles all of them at once.
``DISPATCH_COUNTS[(op, path)]`` counts calls per path ("cuda" or
"plain"); the kernels' own launch counts are ``cuda.LAUNCHES``.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

import torch

from . import bitonic, bucketize, fused

__all__ = [
    "sort", "sort_kv", "searchsorted", "sort_partition",
    "sort_partition_kv", "segments", "merge_sorted_rows",
    "merge_sorted_rows_kv", "pad_pow2",
    "kernel_eligible", "sort_kernel_choice", "reset_dispatch_counts",
    "DISPATCH_COUNTS", "MAX_KERNEL_LANES", "RANK_MERGE_BOUND_BLOCK",
    "MERGE_TILE_LANES",
]

# The reference's VMEM-sized constants (src/repro/kernels/ops.py:108,
# :114 and bitonic.py:294), kept at their values so the port takes the
# same merge path as the reference at every shape.  The CUDA kernels
# size their own shared-memory tiles (csrc/*.cu); re-sizing these gates
# for the H100 comes with the kernel redesigns.
MAX_KERNEL_LANES = 1 << 16
RANK_MERGE_BOUND_BLOCK = 1 << 11
MERGE_TILE_LANES = bitonic.MERGE_TILE_LANES

DISPATCH_COUNTS: collections.Counter = collections.Counter()
_COUNTS_LOCK = threading.Lock()

_next_pow2 = bitonic._next_pow2


def reset_dispatch_counts() -> None:
    with _COUNTS_LOCK:
        DISPATCH_COUNTS.clear()


def _tick(op: str, x: torch.Tensor) -> None:
    with _COUNTS_LOCK:
        DISPATCH_COUNTS[(op, "cuda" if x.is_cuda else "plain")] += 1


def _key_dtype_ok(x) -> bool:
    return x.dtype in bitonic.KEY_DTYPES


def _lanes_ok(n: int) -> bool:
    return 1 <= _next_pow2(n) <= MAX_KERNEL_LANES


def pad_pow2(x: torch.Tensor, fill=None, axis: int = -1) -> torch.Tensor:
    """Pad the per-machine axis to the next power of two (min 2).

    ``axis`` is the last one for keys; a values array (t, m, ...) pads
    axis 1.  ``fill`` defaults to the dtype's sort sentinel, which
    sorts last: a round pads once, then calls ``sort(...,
    prepadded=True)`` and ``searchsorted(..., valid_len=m)`` over the
    padded rows.
    """
    axis = axis % x.dim()
    n = x.shape[axis]
    np2 = max(2, _next_pow2(n))
    if np2 == n:
        return x
    if fill is None:
        fill = bitonic.sort_sentinel(x.dtype)
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, np2 - n]
    return torch.nn.functional.pad(x, widths, value=fill)


def kernel_eligible(op: str, x: torch.Tensor, y=None) -> bool:
    """Would the kernels take these operands?  Shape/dtype gate only.

    ``y`` is the second operand where the op has one (sort_kv values,
    searchsorted queries, merge payload).
    """
    if op == "sort":
        return x.dim() in (1, 2) and _key_dtype_ok(x) and _lanes_ok(x.shape[-1])
    if op == "sort_kv":
        return (x.dim() in (1, 2) and _key_dtype_ok(x)
                and _lanes_ok(x.shape[-1])
                and (y is None or y.shape[:x.dim()] == x.shape))
    if op == "searchsorted":
        return (x.dim() in (1, 2) and y is not None and y.dim() in (1, 2)
                and y.dim() <= x.dim() and x.shape[-1] > 0
                and y.shape[-1] > 0 and _key_dtype_ok(x)
                and x.dtype == y.dtype and _lanes_ok(x.shape[-1]))
    if op in ("sort_partition", "sort_partition_kv"):
        return (x.dim() in (1, 2) and _key_dtype_ok(x)
                and _lanes_ok(x.shape[-1]) and y is not None
                and y.dim() in (1, 2) and y.dim() <= x.dim()
                and y.shape[-1] > 0 and x.dtype == y.dtype
                and _lanes_ok(y.shape[-1]))
    if op in ("merge_sorted_rows", "merge_sorted_rows_kv"):
        if x.dim() not in (2, 3) or not _key_dtype_ok(x):
            return False
        if y is not None and y.shape[:x.dim()] != x.shape:
            return False
        t, c = x.shape[-2:]
        tp2, cp2 = _next_pow2(t), _next_pow2(max(2, c))
        if _lanes_ok(tp2 * cp2):
            return True               # in-tile bitonic merge
        return _lanes_ok(cp2) and tp2 <= 512   # rank merge
    raise ValueError(f"unknown op {op!r}")


def _require(op: str, x: torch.Tensor, y=None) -> None:
    if not kernel_eligible(op, x, y):
        shapes = tuple(x.shape) if y is None else (tuple(x.shape),
                                                   tuple(y.shape))
        raise ValueError(f"{op}: operands {shapes} of {x.dtype} are outside "
                         f"the kernels' gate (float32/int32 keys, padded "
                         f"rows of at most {MAX_KERNEL_LANES} lanes)")


def sort_kernel_choice(x: torch.Tensor) -> str:
    """The sort-kernel family: always ``"bitonic"`` in the port.

    The reference's cost model (src/repro/kernels/ops.py:329-358) picks
    its LSD radix kernel past 8192 lanes on compiled TPU backends, and
    bitonic under interpret mode; outputs are bitwise the same either
    way.  Radix (kernels/radix.py radix_sort) is not ported yet -- see
    ROADMAP.md queue B -- so the port pins the bitonic family.
    """
    return "bitonic"


def sort(x: torch.Tensor, *, prepadded: bool = False) -> torch.Tensor:
    """Ascending sort along the last axis.  x: (n,) or (rows, n).

    ``prepadded=True`` declares the rows already padded to a power of
    two with the sort sentinel (``pad_pow2``); the result then stays
    padded, sentinel tail last.
    """
    if prepadded and x.shape[-1] != max(2, _next_pow2(x.shape[-1])):
        raise ValueError(f"prepadded=True requires a power-of-two row "
                         f"length (use ops.pad_pow2), got {x.shape[-1]}")
    _require("sort", x)
    _tick("sort", x)
    x2 = x[None] if x.dim() == 1 else x
    out = bitonic.bitonic_sort(x2)
    return out[0] if x.dim() == 1 else out


def _take_rows(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """values (rows, n, ...) gathered along axis 1 by order (rows, n')."""
    rows = torch.arange(order.shape[0], device=order.device)[:, None]
    return values[rows, order.long()]


def sort_kv(keys: torch.Tensor, values: torch.Tensor, *,
            prepadded: bool = False):
    """Stable sort of (keys, values) by key: returns (sorted, permuted).

    keys: (n,) or (rows, n); values: leading dims those of keys, extra
    trailing dims ride along.  Realizes the stable argsort as the
    reference's kernel path does: the pair sort of (key, arange(n))
    (``bitonic.bitonic_sort_kv``), then one gather of the values, so key
    ties keep input order bitwise.  ``prepadded=True``: both operands
    were padded to the same power of two (keys with their sort
    sentinel); outputs stay padded, pads last.
    """
    if prepadded and (keys.shape[-1] != max(2, _next_pow2(keys.shape[-1]))
                      or values.shape[:keys.dim()] != keys.shape):
        raise ValueError("prepadded=True requires both operands padded to "
                         "the same power-of-two length (use ops.pad_pow2)")
    _require("sort_kv", keys, values)
    _tick("sort_kv", keys)
    k2 = keys[None] if keys.dim() == 1 else keys
    v2 = values[None] if keys.dim() == 1 else values
    rows, n = k2.shape
    iota = torch.arange(n, dtype=torch.int32, device=keys.device)
    ks, order = bitonic.bitonic_sort_kv(k2.contiguous(),
                                        iota.repeat(rows, 1))
    vs = _take_rows(v2, order)
    return (ks[0], vs[0]) if keys.dim() == 1 else (ks, vs)


def searchsorted(sorted_arr: torch.Tensor, queries: torch.Tensor, *,
                 side: str = "left",
                 valid_len: Optional[int] = None) -> torch.Tensor:
    """Row-wise ``searchsorted(sorted_arr, queries, side)``, int32.

    sorted_arr: (n,) or (B, n); queries: (q,) -- the same queries for
    every row -- or (B, q).  ``valid_len=m`` is the pre-padded path:
    rows may carry a sentinel tail past m real elements and results are
    clamped to m, which reproduces the unpadded answer exactly.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if queries.shape[-1] == 0:          # t == 1: nothing to cut
        shape = sorted_arr.shape[:-1] + (0,)
        return torch.zeros(shape, dtype=torch.int32, device=sorted_arr.device)
    _require("searchsorted", sorted_arr, queries)
    _tick("searchsorted", sorted_arr)
    arr2 = sorted_arr[None] if sorted_arr.dim() == 1 else sorted_arr
    q2 = queries.expand(arr2.shape[0], queries.shape[-1]).contiguous()
    ids = bucketize.searchsorted(arr2.contiguous(), q2, side=side)
    if valid_len is not None:
        ids = torch.clamp_max(ids, int(valid_len))
    return ids[0] if sorted_arr.dim() == 1 else ids


def segments(cuts: torch.Tensor, m: int):
    """(rows, nq) cuts of rows of m keys -> their nq + 1 contiguous
    segments as (starts, lens), each (rows, nq + 1) int32."""
    zeros = torch.zeros(cuts.shape[:-1] + (1,), dtype=torch.int32,
                        device=cuts.device)
    full = torch.full_like(zeros, m)
    starts = torch.cat([zeros, cuts], dim=-1)
    return starts, torch.cat([cuts, full], dim=-1) - starts


def _query_rows(x2: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    """The interior boundaries as one contiguous query row per key row."""
    return interior.expand(x2.shape[0], interior.shape[-1]).contiguous()


def sort_partition(x: torch.Tensor, interior: torch.Tensor):
    """Fused local sort and contiguous-destination partition.

    x: (m,) or (rows, m) unsorted keys; interior: (nq,) ascending
    boundaries shared by every row, or (rows, nq).  Returns
    ``(xs, starts, lens)``: the sorted rows and each row's nq+1
    segments, ``starts``/``lens`` (rows, nq+1) int32 -- bitwise ``sort``
    then ``searchsorted(side="left")``, in one kernel
    (``fused.sort_partition``).  With no boundaries (t = 1) it sorts,
    as the reference does.
    """
    x2 = x[None] if x.dim() == 1 else x
    m = x2.shape[-1]
    if interior.shape[-1] == 0:          # t == 1: sort only
        xs = sort(x2)
        cuts = torch.zeros((x2.shape[0], 0), dtype=torch.int32,
                           device=x.device)
    else:
        _require("sort_partition", x, interior)
        _tick("sort_partition", x)
        xs, cuts = fused.sort_partition(x2.contiguous(),
                                        _query_rows(x2, interior))
    starts, lens = segments(cuts, m)
    if x.dim() == 1:
        return xs[0], starts[0], lens[0]
    return xs, starts, lens


def sort_partition_kv(keys: torch.Tensor, values: torch.Tensor,
                      interior: torch.Tensor):
    """Payload-carrying :func:`sort_partition`, stable.

    keys: (m,) or (rows, m); values: leading dims those of keys, extra
    trailing dims ride along; interior as for :func:`sort_partition`.
    Returns ``(keys_sorted, values_permuted, starts, lens)``: the
    stable argsort from the fused (key, iota) pair sort
    (``fused.sort_partition_kv``) and one gather of the values.
    """
    if values.shape[:keys.dim()] != keys.shape:
        raise ValueError(f"sort_partition_kv: values {tuple(values.shape)} "
                         f"do not align with keys {tuple(keys.shape)}")
    k2 = keys[None] if keys.dim() == 1 else keys
    v2 = values[None] if keys.dim() == 1 else values
    m = k2.shape[-1]
    if interior.shape[-1] == 0:          # t == 1: sort only
        ks, vs = sort_kv(k2, v2)
        cuts = torch.zeros((k2.shape[0], 0), dtype=torch.int32,
                           device=keys.device)
    else:
        _require("sort_partition_kv", keys, interior)
        _tick("sort_partition_kv", keys)
        ks, order, cuts = fused.sort_partition_kv(k2.contiguous(),
                                                  _query_rows(k2, interior))
        vs = _take_rows(v2, order)
    starts, lens = segments(cuts, m)
    if keys.dim() == 1:
        return ks[0], vs[0], starts[0], lens[0]
    return ks, vs, starts, lens


def _merge_fits_one_tile(t: int, c: int) -> bool:
    return _lanes_ok(_next_pow2(t) * _next_pow2(max(2, c)))


def _rank_merge(keys: torch.Tensor, with_order: bool = False):
    """Scale-out merge: global (key, flat-id) ranks, then a scatter.

    keys: (batch, t, c) sorted rows.  Every element's final position is
    its rank in the lexicographic (key, id) order (``fused.merge_ranks``,
    bound rows blocked past ``RANK_MERGE_BOUND_BLOCK``); the scatter
    places the keys and, with ``with_order``, the flat ids, which are
    then the stable flat argsort.  The positions are a permutation, so
    the scatter is deterministic.  Returns (merged (batch, t*c), order
    (batch, t*c) int32 or None).
    """
    batch, t, c = keys.shape
    kp = bitonic._pad_sorted_rows(keys, bitonic.sort_sentinel(keys.dtype))
    tp2, cp2 = kp.shape[-2:]
    ip = bitonic._pad_iota_unique(t, c, tp2, cp2, device=keys.device)
    ip = ip.expand(batch, tp2, cp2).contiguous()
    bound_block = RANK_MERGE_BOUND_BLOCK if cp2 > RANK_MERGE_BOUND_BLOCK \
        else None
    pos = fused.merge_ranks(kp.contiguous(), ip, bound_block=bound_block)
    merged = torch.empty((batch, tp2 * cp2), dtype=keys.dtype,
                         device=keys.device)
    pos = pos.reshape(batch, -1).long()
    merged.scatter_(1, pos, kp.reshape(batch, -1))
    if not with_order:
        return merged[:, :t * c], None
    order = torch.empty((batch, tp2 * cp2), dtype=torch.int32,
                        device=keys.device)
    order.scatter_(1, pos, ip.reshape(batch, -1))
    return merged[:, :t * c], order[:, :t * c]


def merge_sorted_rows(x: torch.Tensor) -> torch.Tensor:
    """Merge already-sorted rows into one sorted vector.

    x: (t, c) -> (t*c,), or (batch, t, c) -> (batch, t*c).  The in-tile
    bitonic merge while the padded t*c fits ``MAX_KERNEL_LANES``, the
    rank merge beyond, as in the reference.
    """
    _require("merge_sorted_rows", x)
    _tick("merge_sorted_rows", x)
    if _merge_fits_one_tile(*x.shape[-2:]):
        return bitonic.merge_sorted_rows(x)
    xb = x[None] if x.dim() == 2 else x
    merged, _ = _rank_merge(xb)
    return merged[0] if x.dim() == 2 else merged


def merge_sorted_rows_kv(keys: torch.Tensor, values: torch.Tensor):
    """Merge sorted rows carrying payload.

    keys: (t, c) or (batch, t, c); values: the same leading dims, extra
    trailing dims ride along.  Returns (merged keys (t*c,) or
    (batch, t*c), values (t*c, ...) or (batch, t*c, ...)): the stable
    flat argsort (ties keep buffer order), from the in-tile argsort
    merge while the padded t*c fits ``MAX_KERNEL_LANES`` and from the
    rank merge's order channel beyond, as in the reference.
    """
    _require("merge_sorted_rows_kv", keys, values)
    _tick("merge_sorted_rows_kv", keys)
    kb = keys[None] if keys.dim() == 2 else keys
    vb = values[None] if keys.dim() == 2 else values
    batch, t, c = kb.shape
    if _merge_fits_one_tile(t, c):
        merged, order = bitonic.merge_sorted_rows_argsort(kb.contiguous())
    else:
        merged, order = _rank_merge(kb, with_order=True)
    vs = _take_rows(vb.reshape(batch, t * c, *vb.shape[3:]), order)
    return (merged[0], vs[0]) if keys.dim() == 2 else (merged, vs)
