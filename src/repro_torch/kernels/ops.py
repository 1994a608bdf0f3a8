"""Kernel dispatch for the port: the single entry the cluster code calls.

Counterpart of ``src/repro/kernels/ops.py`` for SMMS with and without
values, Terasort, RandJoin's routing and the local equi-join
(``sort``, ``sort_kv``, ``searchsorted``, ``sort_partition``,
``sort_partition_kv``, ``merge_sorted_rows``, ``merge_sorted_rows_kv``),
the fused ``bucketize_histogram`` and the LM's ``flash_attention``.
The reference picks between a Pallas backend and a jnp backend and
falls back to jnp for operands a kernel cannot take.  The port has no
backend switch and no fallback:

* which implementation runs is decided by the operand's device alone --
  a CUDA tensor launches the hand-written kernel, a CPU tensor runs the
  kernel's plain PyTorch version (the same network or search in torch
  ops, which is how the tests hold the port against the reference);
* the kernels take every operand the reference's ``ops`` takes
  (:func:`kernel_eligible`: float32, bfloat16 or int32 keys, rows of
  any width); where the reference falls back to jnp past its VMEM-sized
  gate, the port picks another kernel of its own (the radix sort past
  the bitonic tile's reach, the rank merge past one tile, the search
  and the histogram at any width);
* any other operand (another dtype, a rank the ops do not take)
  raises on either device, so a CUDA run can never end up in a library
  sort.

The sorts come in two kernel families, as in the reference: the bitonic
network (``bitonic.py``, ``fused.py``) and the LSD radix sort
(``radix.py``).  :func:`sort_kernel_choice` picks one: a family forced
with :func:`force_sort_kernel` wins; otherwise a CPU operand takes
bitonic (the reference pins bitonic under interpret mode) and a CUDA
operand the reference's cost model with constants fitted on the H100.
Both families give the same keys and the same stable order.

The sort-side operands carry the machine axis first: a (t, m) array
is t machines' rows, and every call handles all of them at once.
``DISPATCH_COUNTS[(op, path)]`` counts calls per path: "cuda" or
"plain" for the bitonic family and the other ops, "radix-cuda" or
"radix-plain" for the radix family; the kernels' own launch counts are
``cuda.LAUNCHES``.  Each dispatch also ticks the obs registry's
``kernel_dispatch_traces_total{op, path}`` counter and lands a
``kernel_dispatch`` event on the open trace span, as the reference's
``_tick`` does.

Where the port's counts differ from the reference's: the reference's
``DISPATCH_COUNTS`` ticks once per *trace*, and a query served from its
compiled-program cache ticks nothing; its opt-in second counter
ticks per *execution*.  The port compiles nothing: every call
dispatches and executes, so ``DISPATCH_COUNTS`` and
``kernel_dispatch_traces_total`` count executions too, and the port
keeps no second counter.  Nor does it keep the reference's opt-in
histogram of each op's host time: an op's device time is read from the
profiler, under the ``obs.trace`` spans around it.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import torch

from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from . import bitonic, bucketize, fused, radix
from . import flash_attention as fa
from .radix import bits_to_key, key_to_bits

__all__ = [
    "sort", "sort_kv", "searchsorted", "sort_partition",
    "sort_partition_kv", "segments", "merge_sorted_rows",
    "merge_sorted_rows_kv", "bucketize_histogram", "flash_attention",
    "pad_pow2",
    "kernel_eligible", "sort_kernel_choice", "force_sort_kernel",
    "reset_dispatch_counts", "DISPATCH_COUNTS", "MAX_KERNEL_LANES",
    "RANK_MERGE_BOUND_BLOCK", "MERGE_TILE_LANES", "RADIX_BITS",
    "RADIX_MIN_LANES", "RADIX_PASS_SUBSTAGES", "key_to_bits",
    "bits_to_key",
]

# Which kernel runs, not what is admitted.  The reference's VMEM-sized
# constants (src/repro/kernels/ops.py:108, :114 and bitonic.py:294),
# kept at their values so the port takes the same kernels as the
# reference at every shape its kernels take: MAX_KERNEL_LANES is the
# bitonic tile's reach (past it a row sorts by the radix family, and t
# landed rows merge by the rank merge once their padded t * c passes
# it; that crossover is still the TPU's, not fitted on the H100).
# RANK_MERGE_BOUND_BLOCK is the reference's bound-row block (its
# _rank_merge blocks rows wider than it): the CUDA rank merge merges the
# landed rows at their own width and sizes its shared-memory tiles
# itself (csrc/merge_ranks.cu); the block matters only where an entry's
# keys hold a NaN, and fused.rank_merge replays the reference's blocked
# searches there.  It is also the block a caller hands fused.merge_ranks
# to run the reference's blocked variant.
MAX_KERNEL_LANES = 1 << 16
RANK_MERGE_BOUND_BLOCK = fused.RANK_MERGE_BOUND_BLOCK
MERGE_TILE_LANES = bitonic.MERGE_TILE_LANES

# The sort-family split (reference ops.py:116-135): radix wins once the
# network's log2(n)(log2(n)+1)/2 compare-exchange substages exceed
# ceil(key_bits / RADIX_BITS) counting passes of RADIX_PASS_SUBSTAGES
# substages each, on rows of at least RADIX_MIN_LANES.  Fitted on the
# H100 by chip_smoke.py's crossover table (PERF.md) on float32, bf16 and
# int32 keys, against the 8-bit onesweep radix kernel: at (64, 2^k),
# k = 13..16, radix was faster on bf16 keys at 2^15 and 2^16 and nowhere
# else.  The model agrees with that run for values in [27, 30): 27, the
# least.  bf16 keys take the reference's 4 passes, 4 x 27 = 108 substages,
# between the network's 105 at 2^14 and 120 at 2^15; 32-bit keys 8 passes
# (216), past the network's 136 at 2^16.  So bf16 rows of 2^15 and 2^16
# sort by radix, every other row of the bitonic tile's reach by bitonic,
# and past the reach every row by radix.  RADIX_MIN_LANES keeps the
# reference's value.
RADIX_BITS = radix.DEFAULT_RADIX_BITS
RADIX_MIN_LANES = 1 << 13
RADIX_PASS_SUBSTAGES = 27

SORT_FAMILIES = ("bitonic", "radix")
_FORCE_SORT_KERNEL: Optional[str] = None

DISPATCH_COUNTS: collections.Counter = collections.Counter()
_COUNTS_LOCK = threading.Lock()

# (op, path) -> (the registry's generation, its counter): the registry
# is looked up once a generation, not once a dispatch
_TICKS: dict = {}

_next_pow2 = bitonic._next_pow2


def reset_dispatch_counts() -> None:
    """Clear the per-call counter (the registry's counters are reset by
    ``repro_torch.obs.reset_registry``)."""
    with _COUNTS_LOCK:
        DISPATCH_COUNTS.clear()


def _tick(op: str, x: torch.Tensor, family: str = "bitonic") -> None:
    path = "cuda" if x.is_cuda else "plain"
    if family == "radix":
        path = "radix-" + path
    key = (op, path)
    with _COUNTS_LOCK:
        DISPATCH_COUNTS[key] += 1
    hit = _TICKS.get(key)
    if hit is None or hit[0] != REGISTRY.generation:
        hit = _TICKS[key] = (REGISTRY.generation, REGISTRY.counter(
            "kernel_dispatch_traces_total", op=op, path=path))
    hit[1].inc()
    obs_trace.event("kernel_dispatch", op=op, path=path)


def _key_dtype_ok(x) -> bool:
    return x.dtype in bitonic.KEY_DTYPES


def _fits_tile(n: int) -> bool:
    """Within the bitonic tile's reach: a padded row of n lanes."""
    return _next_pow2(n) <= MAX_KERNEL_LANES


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
    """Do the kernels take these operands?  Shape/dtype gate only.

    What is admitted, at any row width: float32, bfloat16 or int32 keys
    (the reference's ``_KERNEL_KEY_DTYPES``) of the ranks the ops take.
    Which kernel then runs is :func:`sort_kernel_choice`'s and the
    merge's business.  ``y`` is the second operand where the op has one
    (sort_kv values, searchsorted queries, merge payload).
    """
    if op in ("sort", "radix"):
        return x.dim() in (1, 2) and _key_dtype_ok(x)
    if op == "sort_kv":
        return (x.dim() in (1, 2) and _key_dtype_ok(x)
                and (y is None or y.shape[:x.dim()] == x.shape))
    if op == "searchsorted":
        return (x.dim() in (1, 2) and y is not None and y.dim() in (1, 2)
                and y.dim() <= x.dim() and x.shape[-1] > 0
                and y.shape[-1] > 0 and _key_dtype_ok(x)
                and x.dtype == y.dtype)
    if op in ("sort_partition", "sort_partition_kv"):
        return (x.dim() in (1, 2) and _key_dtype_ok(x) and y is not None
                and y.dim() in (1, 2) and y.dim() <= x.dim()
                and y.shape[-1] > 0 and x.dtype == y.dtype)
    if op == "bucketize_histogram":
        # 1-D keys and boundaries of one key dtype (the reference's
        # ops.py:301, less its lane gate: the kernel takes any count)
        return (x.dim() == 1 and y is not None and y.dim() == 1
                and _key_dtype_ok(x) and x.dtype == y.dtype)
    if op in ("merge_sorted_rows", "merge_sorted_rows_kv"):
        return (x.dim() in (2, 3) and _key_dtype_ok(x)
                and (y is None or y.shape[:x.dim()] == x.shape))
    raise ValueError(f"unknown op {op!r}")


def _require(op: str, x: torch.Tensor, y=None) -> None:
    if not kernel_eligible(op, x, y):
        shapes = tuple(x.shape) if y is None else (tuple(x.shape),
                                                   tuple(y.shape))
        dtypes = x.dtype if y is None else (x.dtype, y.dtype)
        raise ValueError(f"{op}: operands {shapes} of {dtypes} are outside "
                         f"what the port's kernels take (float32, bfloat16 "
                         f"or int32 keys of the ops' ranks, one key dtype "
                         f"for both operands; ROADMAP C10)")


def sort_kernel_choice(x: torch.Tensor) -> str:
    """The sort-kernel family for ``x``: ``"bitonic"`` or ``"radix"``.

    A row past the bitonic tile's reach (padded width above
    ``MAX_KERNEL_LANES``) sorts by radix on either device, whatever is
    forced: the radix kernel takes any width, and the reference's jnp
    fallback there is a stable sort, which the radix family equals.
    Otherwise a family forced with :func:`force_sort_kernel` wins; a
    CPU operand takes bitonic, as the reference pins bitonic while its
    kernels run in interpret mode (src/repro/kernels/ops.py:348-349), so
    the CPU runs the family the reference runs there.  A CUDA operand
    takes the reference's cost model (:329-358): radix past
    ``RADIX_MIN_LANES`` once the bitonic network's substages over the
    padded row exceed the radix passes' cost.  The constants are fitted
    on the H100 (PERF.md, the crossover table).  Pure function of
    device, shape, dtype and the constants; outputs are bitwise the
    same either way.
    """
    if not _fits_tile(x.shape[-1]):
        return "radix"
    if _FORCE_SORT_KERNEL is not None:
        return _FORCE_SORT_KERNEL
    if not x.is_cuda or not _key_dtype_ok(x):
        return "bitonic"
    n = x.shape[-1]
    if n < RADIX_MIN_LANES:
        return "bitonic"
    logn = max(1, max(2, _next_pow2(n)).bit_length() - 1)
    bitonic_substages = logn * (logn + 1) // 2
    passes = -(-radix.key_bits(x.dtype) // RADIX_BITS)
    if bitonic_substages > passes * RADIX_PASS_SUBSTAGES:
        return "radix"
    return "bitonic"


@contextlib.contextmanager
def force_sort_kernel(kind: Optional[str]):
    """Pin :func:`sort_kernel_choice` to one family for the duration.

    ``kind``: ``"radix"``, ``"bitonic"``, or None (the cost model).
    Raises on any other family.  Used by the tests, which run the radix
    family on the CPU, and by ``chip_smoke.py``, which drives each
    family on the card.
    """
    if kind is not None and kind not in SORT_FAMILIES:
        raise ValueError(f"unknown sort kernel family {kind!r}")
    global _FORCE_SORT_KERNEL
    prev = _FORCE_SORT_KERNEL
    _FORCE_SORT_KERNEL = kind
    try:
        yield
    finally:
        _FORCE_SORT_KERNEL = prev


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
    x2 = x[None] if x.dim() == 1 else x
    if sort_kernel_choice(x) == "radix":
        _tick("sort", x, "radix")
        out, _ = radix.radix_sort(x2.contiguous())
    else:
        _tick("sort", x)
        out = bitonic.bitonic_sort(x2)
    return out[0] if x.dim() == 1 else out


def _take_rows(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """values (rows, n, ...) gathered along axis 1 by order (rows, n').

    Ids out of [0, n) are taken as JAX indexing takes them (the
    reference's ``vflat[order]``): a negative id counts from the end,
    then every id is clamped into the row.  The argsort merge leaves a
    pad's id (>= n) in ``order`` where a landed row holds a NaN key
    (ROADMAP C14), in the reference too.
    """
    n = values.shape[1]
    idx = order.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    rows = torch.arange(order.shape[0], device=order.device)[:, None]
    return values[rows, idx]


def sort_kv(keys: torch.Tensor, values: torch.Tensor, *,
            prepadded: bool = False):
    """Stable sort of (keys, values) by key: returns (sorted, permuted).

    keys: (n,) or (rows, n); values: leading dims those of keys, extra
    trailing dims ride along.  Realizes the stable argsort as the
    reference's kernel path does, then one gather of the values, so key
    ties keep input order bitwise: the radix family's order channel
    (``radix.radix_sort``), or the bitonic family's pair sort of (key,
    arange(n)) (``bitonic.bitonic_sort_kv`` with no values: the kernel
    generates the iota).  ``prepadded=True``: both
    operands were padded to the same power of two (keys with their sort
    sentinel); outputs stay padded, pads last (pad-slot ties resolve by
    position).
    """
    if prepadded and (keys.shape[-1] != max(2, _next_pow2(keys.shape[-1]))
                      or values.shape[:keys.dim()] != keys.shape):
        raise ValueError("prepadded=True requires both operands padded to "
                         "the same power-of-two length (use ops.pad_pow2)")
    _require("sort_kv", keys, values)
    k2 = keys[None] if keys.dim() == 1 else keys
    v2 = values[None] if keys.dim() == 1 else values
    if sort_kernel_choice(keys) == "radix":
        # the order comes out of the counting passes: one gather carries
        # the payload, no (key, iota) pair sort
        _tick("sort_kv", keys, "radix")
        ks, order = radix.radix_sort(k2.contiguous())
    else:
        _tick("sort_kv", keys)
        ks, order = bitonic.bitonic_sort_kv(k2.contiguous())
    vs = _take_rows(v2, order)
    return (ks[0], vs[0]) if keys.dim() == 1 else (ks, vs)


def _bf16_queries(queries: torch.Tensor, side: str) -> torch.Tensor:
    """float32 queries as the bf16 queries that cut bf16 rows at the same
    places: for a bf16 key a, a < q iff a < q rounded up to bf16, and
    a <= q iff a <= q rounded down.  Exact, in the comparator's
    classes (denormals and -0.0 fold to 0 first).  This is the
    reference's jnp search over a bf16 row with float32 queries (SMMS's
    Round-2 boundaries), which promotes both to float32."""
    q = bitonic.ftz(queries)
    r = q.to(torch.bfloat16)                            # to nearest
    off = r.float() < q if side == "left" else r.float() > q
    # where r missed, one bf16 step toward q: up (left) or down (right);
    # on the bits, +1 moves a positive value up and a negative one down
    bits = r.view(torch.int16).to(torch.int32)
    step = torch.where((bits < 0) == (side == "left"), -1, 1)
    bits = torch.where(off, bits + step, bits)
    return bits.to(torch.int16).view(torch.bfloat16)


def searchsorted(sorted_arr: torch.Tensor, queries: torch.Tensor, *,
                 side: str = "left",
                 valid_len: Optional[int] = None) -> torch.Tensor:
    """Row-wise ``searchsorted(sorted_arr, queries, side)``, int32.

    sorted_arr: (n,) or (B, n); queries: (q,) -- the same queries for
    every row, handed to the kernel as they are -- or (B, q).
    ``valid_len=m`` is the pre-padded path: rows may carry a sentinel
    tail past m real elements and results are clamped to m (by the
    kernel), which reproduces the unpadded answer exactly.  bf16 rows
    take float32 queries too, as exact bf16 queries
    (:func:`_bf16_queries`).
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if queries.shape[-1] == 0:          # t == 1: nothing to cut
        shape = sorted_arr.shape[:-1] + (0,)
        return torch.zeros(shape, dtype=torch.int32, device=sorted_arr.device)
    if (sorted_arr.dtype == torch.bfloat16
            and queries.dtype == torch.float32):
        queries = _bf16_queries(queries, side)
    _require("searchsorted", sorted_arr, queries)
    _tick("searchsorted", sorted_arr)
    if sorted_arr.dim() == 1:
        return bucketize.searchsorted(sorted_arr.contiguous()[None],
                                      queries.contiguous(), side=side,
                                      valid_len=valid_len)[0]
    return bucketize.searchsorted(sorted_arr.contiguous(),
                                  queries.contiguous(), side=side,
                                  valid_len=valid_len)


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
    (``fused.sort_partition``).  The radix family has no fused search,
    as in the reference (ops.py:510-517): it sorts, then searches, two
    kernels.  With no boundaries (t = 1) it sorts, as the reference
    does.
    """
    x2 = x[None] if x.dim() == 1 else x
    m = x2.shape[-1]
    if interior.shape[-1] == 0:          # t == 1: sort only
        xs = sort(x2)
        cuts = torch.zeros((x2.shape[0], 0), dtype=torch.int32,
                           device=x.device)
    elif (kernel_eligible("sort_partition", x, interior)
          and sort_kernel_choice(x) == "radix"):
        xs = sort(x2)
        cuts = searchsorted(xs, interior, side="left")
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
    (``fused.sort_partition_kv``) and one gather of the values; the
    radix family sorts (:func:`sort_kv`), then searches.
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
    elif (kernel_eligible("sort_partition_kv", keys, interior)
          and sort_kernel_choice(keys) == "radix"):
        ks, vs = sort_kv(k2, v2)
        cuts = searchsorted(ks, interior, side="left")
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
    return _fits_tile(_next_pow2(t) * _next_pow2(max(2, c)))


def _rank_merge(keys: torch.Tensor, with_order: bool = False):
    """Scale-out merge of (batch, t, c) sorted rows: the reference's
    ``_rank_merge`` of each batch entry.

    ``fused.rank_merge``.  Where an entry's keys hold no NaN: the keys
    in the lexicographic (key, flat id) order, ids ``row * c + col`` --
    the real part of the reference's padded rows, whose pads rank above
    every real pair -- and the flat ids in that order, the stable flat
    argsort; on the card from the merge kernel's last level, on the CPU
    from the plain ranks of the unpadded rows and a scatter.  Where they
    hold a NaN (ROADMAP C15): the reference's padded ranks, blocked as
    it blocks them, and its last-wins scatter into zeros, from the
    replay kernel on the card and the plain replay on the CPU.  Returns
    (merged (batch, t*c), order (batch, t*c) int32, or None without
    ``with_order``).
    """
    merged, order = fused.rank_merge(keys.contiguous())
    return merged, (order if with_order else None)


def merge_sorted_rows(x: torch.Tensor) -> torch.Tensor:
    """Merge already-sorted rows into one sorted vector.

    x: (t, c) -> (t*c,), or (batch, t, c) -> (batch, t*c).  The in-tile
    bitonic merge while the padded t*c fits ``MAX_KERNEL_LANES``, the
    rank merge beyond (any t, any c: where the reference's own rank
    merge stops, at t > 512 or rows past 2^16, its jnp sort gives the
    same keys).
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
        merged, order = bitonic.merge_sorted_rows_argsort(kb)
    else:
        merged, order = _rank_merge(kb, with_order=True)
    vs = _take_rows(vb.reshape(batch, t * c, *vb.shape[3:]), order)
    return (merged[0], vs[0]) if keys.dim() == 2 else (merged, vs)


def bucketize_histogram(keys: torch.Tensor, boundaries: torch.Tensor,
                        t: int):
    """Fused bucket-id + histogram.  keys: (n,); boundaries: (t-1,)
    ascending.  Returns (ids (n,) int32, counts (t,) int32), ids per
    ``searchsorted(boundaries, key, side='right')``, any number of
    boundaries.  Operands of other dtypes raise on either device.
    """
    _require("bucketize_histogram", keys, boundaries)
    _tick("bucketize_histogram", keys)
    return bucketize.bucketize_histogram(keys.contiguous(),
                                         boundaries.contiguous(), t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Blocked online-softmax attention with GQA and a sliding window.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), float32 or bfloat16, D <=
    256; queries right-aligned to the keys.  Returns (B, Hq, Sq, D).
    Operands outside the kernel's gate raise on either device.
    """
    out = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window)
    _tick("flash_attention", q)
    return out
