"""Bitonic sort and merge networks: the Round-1 sort and the in-tile
receive merge of SMMS.

Counterpart of ``src/repro/kernels/bitonic.py``.  Four kernels, each
with its plain PyTorch version beside it:

* :func:`bitonic_sort` -- ascending sort of each row of (rows, n);
  CUDA source ``csrc/bitonic_sort.cu``, one launch a call.
* :func:`bitonic_sort_kv` -- lexicographic (key, int32 value) sort of
  each row; with no values (the kernel generates ``arange(n)``) it is
  the stable argsort.  Same source and schedule.
* :func:`merge_sorted_rows` -- merge of t sorted rows into one sorted
  row, per batch entry; CUDA source ``csrc/merge_rows.cu``.
* :func:`merge_sorted_rows_argsort` -- the same merge carrying each
  element's flat index, which yields the stable flat argsort.  Same
  source.

The plain versions (``*_plain``, built on :func:`sort_network_block`,
:func:`sort_network_block_kv`, :func:`merge_network_block` and
:func:`merge_network_block_kv`) run the reference's network substage
by substage in torch ops.  The CPU runs them; a CUDA tensor launches the
kernel, which performs the same compare-exchanges, so the two agree
bitwise.  Which one runs is decided by the tensor's device alone.

Comparisons fold denormals to zero in the bits domain (:func:`ftz`), as
XLA's comparator does on the reference's CPU and TPU; the data is only
moved, so every output is a permutation of its input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda

__all__ = [
    "bitonic_sort",
    "bitonic_sort_plain",
    "bitonic_sort_kv",
    "bitonic_sort_kv_plain",
    "merge_sorted_rows",
    "merge_sorted_rows_plain",
    "merge_sorted_rows_argsort",
    "merge_sorted_rows_argsort_plain",
    "sort_network_block",
    "sort_network_block_kv",
    "merge_network_block",
    "merge_network_block_kv",
    "sort_sentinel",
    "ftz",
    "as_bits",
    "MERGE_TILE_LANES",
    "SORT_LAUNCH_LANES",
]

# The key dtypes every sort-side kernel takes, as the reference's
# _KERNEL_KEY_DTYPES (src/repro/kernels/ops.py:157-158).  bf16 keys stay
# bf16 in device memory; the kernels widen them to float32 in registers
# to compare them, which is exact and keeps their order.
KEY_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "i32"}

# The reference's soft per-block lane target for its hierarchical merge
# (src/repro/kernels/bitonic.py:294), kept at its value until the gate
# constants are re-sized for the H100.  It groups levels into blocks in
# the reference only; which merge runs is decided by MAX_KERNEL_LANES
# (ops.py), and the CUDA kernel sizes its blocks and clusters itself
# (csrc/merge_rows.cu).
MERGE_TILE_LANES = 1 << 12


def sort_sentinel(dtype: torch.dtype):
    """The value that sorts last for ``dtype``: +inf (floats), max (ints)."""
    if dtype.is_floating_point:
        return math.inf
    return torch.iinfo(dtype).max


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Comparison key: denormals folded to the zero of their sign.

    Done on the bits (an exponent field of 0 keeps only the sign bit),
    because arithmetic such as ``x + 0.0`` does not flush on the CPU.
    bf16 has float32's exponent field, so its denormals are the ones
    XLA flushes when it widens them to compare.  Integer keys are
    returned as they are.
    """
    if x.dtype == torch.float32:
        bits = x.view(torch.int32)
        sign = bits & torch.iinfo(torch.int32).min
        return torch.where((bits & 0x7F800000) == 0, sign,
                           bits).view(torch.float32)
    if x.dtype == torch.bfloat16:
        bits = x.view(torch.int16)
        sign = bits & torch.iinfo(torch.int16).min
        return torch.where((bits & 0x7F80) == 0, sign,
                           bits).view(torch.bfloat16)
    return x


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or a bf16 tensor's int16 view: torch's CPU
    ``gather`` and ``scatter_`` rewrite a bf16 NaN's bits, so keys are
    moved by those two as int16."""
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _compare_exchange(x: torch.Tensor, d: int,
                      descending_runs: torch.Tensor) -> torch.Tensor:
    """One substage: exchange partners at distance d (swap rule)."""
    rows, n = x.shape
    xr = x.reshape(rows, n // (2 * d), 2, d)
    a = xr[:, :, 0, :]
    b = xr[:, :, 1, :]
    swap = (ftz(a) > ftz(b)) != descending_runs[None, :, None]
    lo = torch.where(swap, b, a)
    hi = torch.where(swap, a, b)
    return torch.stack([lo, hi], dim=2).reshape(rows, n)


def _compare_exchange_kv(k: torch.Tensor, v: torch.Tensor, d: int,
                         descending_runs: torch.Tensor):
    """Lexicographic (key, value) compare-exchange at distance d."""
    rows, n = k.shape
    kr = k.reshape(rows, n // (2 * d), 2, d)
    vr = v.reshape(rows, n // (2 * d), 2, d)
    ka, kb = kr[:, :, 0, :], kr[:, :, 1, :]
    va, vb = vr[:, :, 0, :], vr[:, :, 1, :]
    fa, fb = ftz(ka), ftz(kb)
    gt = (fa > fb) | ((fa == fb) & (va > vb))   # pair a sorts after pair b
    swap = gt != descending_runs[None, :, None]
    klo, khi = torch.where(swap, kb, ka), torch.where(swap, ka, kb)
    vlo, vhi = torch.where(swap, vb, va), torch.where(swap, va, vb)
    return (torch.stack([klo, khi], dim=2).reshape(rows, n),
            torch.stack([vlo, vhi], dim=2).reshape(rows, n))


def _directions(n: int, d: int, k: int, device) -> torch.Tensor:
    """Per partner-group descending bit for stage k, distance d."""
    group = torch.arange(n // (2 * d), device=device) * (2 * d)
    return ((group >> (k + 1)) & 1) == 1


def sort_network_block(x: torch.Tensor) -> torch.Tensor:
    """Full bitonic sort of each row of x: (rows, n), n a power of 2.

    The plain version of the ``bitonic_sort`` kernel.
    """
    rows, n = x.shape
    logn = int(math.log2(n))
    assert 1 << logn == n, "n must be a power of 2"
    for k in range(logn):
        for j in range(k, -1, -1):
            d = 1 << j
            x = _compare_exchange(x, d, _directions(n, d, k, x.device))
    return x


def sort_network_block_kv(keys: torch.Tensor, vals: torch.Tensor):
    """Lexicographic (key, value) bitonic sort of each row.

    keys/vals: (rows, n), n a power of 2.  The plain version of the
    ``bitonic_sort_kv`` kernel.
    """
    rows, n = keys.shape
    logn = int(math.log2(n))
    assert 1 << logn == n, "n must be a power of 2"
    for k in range(logn):
        for j in range(k, -1, -1):
            d = 1 << j
            keys, vals = _compare_exchange_kv(
                keys, vals, d, _directions(n, d, k, keys.device))
    return keys, vals


def merge_network_block(x: torch.Tensor, run: int) -> torch.Tensor:
    """Merge rows of x whose length-``run`` chunks are each sorted.

    x: (rows, n); n and run powers of 2, run divides n.  The plain
    version of the ``merge_sorted_rows`` kernel.
    """
    rows, n = x.shape
    lvl = run
    while lvl < n:
        xr = x.reshape(rows, n // (2 * lvl), 2, lvl)
        a = xr[:, :, 0, :]
        b = xr[:, :, 1, :].flip(-1)             # reverse -> bitonic sequence
        y = torch.cat([a, b], dim=-1).reshape(rows, n)
        d = lvl
        while d >= 1:
            y = _compare_exchange(
                y, d, torch.zeros(n // (2 * d), dtype=torch.bool,
                                  device=x.device))
            d //= 2
        x = y
        lvl *= 2
    return x


def merge_network_block_kv(keys: torch.Tensor, vals: torch.Tensor,
                           run: int):
    """:func:`merge_network_block` on (key, value) pairs, lexicographic.

    The plain version of the argsort merge (the reference's
    ``_merge_kv_kernel``).
    """
    rows, n = keys.shape
    lvl = run
    while lvl < n:
        kr = keys.reshape(rows, n // (2 * lvl), 2, lvl)
        vr = vals.reshape(rows, n // (2 * lvl), 2, lvl)
        keys = torch.cat([kr[:, :, 0, :], kr[:, :, 1, :].flip(-1)],
                         dim=-1).reshape(rows, n)
        vals = torch.cat([vr[:, :, 0, :], vr[:, :, 1, :].flip(-1)],
                         dim=-1).reshape(rows, n)
        d = lvl
        while d >= 1:
            keys, vals = _compare_exchange_kv(
                keys, vals, d, torch.zeros(n // (2 * d), dtype=torch.bool,
                                           device=keys.device))
            d //= 2
        lvl *= 2
    return keys, vals


def _check_kernel_operand(name: str, x: torch.Tensor) -> None:
    cuda.check_cuda_tensor(name, x, KEY_DTYPES)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """(rows, n) -> (rows, pow2 >= 2), padded with the sort sentinel."""
    n = x.shape[-1]
    np2 = max(2, _next_pow2(n))
    if np2 == n:
        return x
    return torch.nn.functional.pad(x, (0, np2 - n),
                                   value=sort_sentinel(x.dtype))


def bitonic_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`bitonic_sort`, on any device."""
    return sort_network_block(_pad_row(x))[:, :x.shape[-1]]


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ascending sort.  x: (rows, n), any n >= 1.

    Rows are padded to a power of two (at least 2) with the sort
    sentinel, as the reference pads them, and the padding stripped
    after.  A CUDA tensor runs the kernel (float32, bfloat16 or int32;
    anything else raises), which reads the rows unpadded and writes
    fresh (rows, n) keys in one launch up to ``SORT_LAUNCH_LANES``
    padded slots; a CPU tensor runs :func:`bitonic_sort_plain`.
    """
    if not x.is_cuda:
        return bitonic_sort_plain(x)
    x = x.contiguous()
    _check_kernel_operand("bitonic_sort", x)
    out = torch.empty_like(x)
    cuda.launch("bitonic_sort", f"bitonic_sort_{_SUFFIX[x.dtype]}",
                x.data_ptr(), out.data_ptr(), _ptr(_scratch(x)), x.shape[0],
                x.shape[1])
    return out


# Padded slots of the widest row the sorts take in one launch (a cluster
# of 8 CTAs of 8,192 slots: csrc/sort_tiles.cuh kRowLogLaunch); a wider
# row (direct calls only: the dispatch sends it to the radix sort) is
# sorted in a padded scratch the wrapper allocates.
SORT_LAUNCH_LANES = 1 << 16


def _scratch(keys: torch.Tensor, dtype=None) -> Optional[torch.Tensor]:
    """The padded (rows, pow2 >= 2) scratch a sort kernel call on (rows,
    m) keys needs past ``SORT_LAUNCH_LANES`` (of the keys' dtype, or
    ``dtype``), uninitialised; None up to it."""
    rows, m = keys.shape
    np2 = max(2, _next_pow2(m))
    if np2 <= SORT_LAUNCH_LANES:
        return None
    return torch.empty((rows, np2), dtype=dtype or keys.dtype,
                       device=keys.device)


def _iota_rows(rows: int, m: int, device) -> torch.Tensor:
    """(rows, pow2 >= 2) arange(m) padded with int32 max, as the
    reference pads it (src/repro/kernels/fused.py:111-112): the value
    channel the pair sort kernels generate when given none."""
    iota = torch.arange(m, dtype=torch.int32, device=device)
    return _pad_row(iota.repeat(rows, 1))


def bitonic_sort_kv_plain(keys: torch.Tensor,
                          values: Optional[torch.Tensor] = None):
    """The plain version of :func:`bitonic_sort_kv`, on any device."""
    rows, n = keys.shape
    vs = _iota_rows(rows, n, keys.device) if values is None \
        else _pad_row(values)
    ks, vs = sort_network_block_kv(_pad_row(keys), vs)
    return ks[:, :n], vs[:, :n]


def _pair_operands(keys: torch.Tensor):
    """The outputs of a pair sort kernel call on (rows, m) keys -- the
    keys and the int32 order, (rows, m) -- and its padded scratch (None
    up to ``SORT_LAUNCH_LANES``), all uninitialised: the kernel writes
    them."""
    rows, m = keys.shape
    ks = torch.empty_like(keys)
    order = torch.empty((rows, m), dtype=torch.int32, device=keys.device)
    return ks, order, (_scratch(keys), _scratch(keys, torch.int32))


def bitonic_sort_kv(keys: torch.Tensor,
                    values: Optional[torch.Tensor] = None):
    """Row-wise (key, value) pair sort, values breaking key ties.

    keys: (rows, n); values: (rows, n) int32, or None for the stable
    argsort (each row's value channel is arange(n), which the kernel
    generates).  Rows are padded to a power of two with the sort
    sentinel in both channels (the value sentinel is int32 max), as the
    reference pads them.  A CUDA tensor runs the kernel (float32,
    bfloat16 or int32 keys), which reads the rows unpadded and writes
    fresh (rows, n) outputs in one launch up to
    ``SORT_LAUNCH_LANES`` padded slots; a CPU tensor runs
    :func:`bitonic_sort_kv_plain`.
    """
    if values is not None and keys.shape != values.shape:
        raise ValueError(f"bitonic_sort_kv: keys {tuple(keys.shape)} and "
                         f"values {tuple(values.shape)} differ in shape")
    if not keys.is_cuda:
        return bitonic_sort_kv_plain(keys, values)
    keys = keys.contiguous()
    _check_kernel_operand("bitonic_sort_kv", keys)
    if values is not None:
        values = values.contiguous()
        cuda.check_cuda_tensor("bitonic_sort_kv", values, (torch.int32,))
    ks, order, (sk, sv) = _pair_operands(keys)
    cuda.launch("bitonic_sort_kv", f"bitonic_sort_kv_{_SUFFIX[keys.dtype]}",
                keys.data_ptr(), _ptr(values), ks.data_ptr(),
                order.data_ptr(), _ptr(sk), _ptr(sv), keys.shape[0],
                keys.shape[1])
    return ks, order


def _pad_sorted_rows(x: torch.Tensor, sentinel) -> torch.Tensor:
    """Pad (..., t, c) sorted rows to (..., pow2, pow2); rows stay sorted."""
    t, c = x.shape[-2:]
    tp2 = max(1, _next_pow2(t))
    cp2 = max(2, _next_pow2(c))
    return torch.nn.functional.pad(x, (0, cp2 - c, 0, tp2 - t), value=sentinel)


def _pad_iota_unique(t: int, c: int, tp2: int, cp2: int,
                     device=None) -> torch.Tensor:
    """Flat-index channel for (t, c) rows padded to (tp2, cp2).

    Real slots carry their row-major flat index in [0, t*c); pad slots
    carry unique ids >= t*c, ascending along each row, so (key, id)
    pairs stay strictly increasing per row.
    """
    row = torch.arange(tp2, dtype=torch.int32, device=device)[:, None]
    col = torch.arange(cp2, dtype=torch.int32, device=device)[None, :]
    real = (row < t) & (col < c)
    flatpos = row * cp2 + col
    return torch.where(real, row * c + col, t * c + flatpos)


def _padded_slots(x: torch.Tensor):
    """(batch, t, c) sorted rows -> the reference's padded entry, slot by
    slot, as the merge kernel loads it: (keys (batch, tp2*cp2), ids
    (tp2*cp2,) int32, cp2).  Slot s = row*cp2 + col holds x[row, col]
    and id row*c + col where row < t and col < c, the sort sentinel and
    id t*c + s otherwise -- ``_pad_sorted_rows`` and
    ``_pad_iota_unique`` flattened."""
    batch, t, c = x.shape
    tp2, cp2 = max(1, _next_pow2(t)), max(2, _next_pow2(c))
    slot = torch.arange(tp2 * cp2, dtype=torch.int32, device=x.device)
    row, col = slot // cp2, slot % cp2
    real = (row < t) & (col < c)
    ids = torch.where(real, row * c + col, t * c + slot)
    # moved as bits: torch's CPU gather rewrites a bf16 NaN's bits
    bits = _key_bits(x).reshape(batch, t * c)
    pad = torch.tensor(sort_sentinel(x.dtype), dtype=x.dtype)
    keys = torch.where(real, bits[:, torch.where(real, ids, 0).long()],
                       _key_bits(pad).to(x.device))
    return keys.view(x.dtype), ids, cp2


def _key_bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the integers of its bits (float32 as int32, bf16 as
    int16; int32 as it is)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else as_bits(x)


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.dim() == 2 else x


def merge_sorted_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`merge_sorted_rows`, on any device."""
    xb = _as_batch(x)
    flat, _, run = _padded_slots(xb)
    merged = merge_network_block(flat, run)[:, :xb.shape[1] * xb.shape[2]]
    return merged[0] if x.dim() == 2 else merged


# (key dtype, with ids) -> lanes of the largest padded entry the merge
# kernel merges in shared memory in one launch (merge_rows.cu)
_LAUNCH_LANES: dict = {}


def _merge_operand(name: str, x: torch.Tensor, kv: bool):
    """The checked (batch, t, c) operand of a merge kernel call, its
    outputs (batch, t*c) -- the keys, and with ``kv`` the int32 order --
    and, where the padded entry outgrows one launch, the padded
    (batch, tp2*cp2) scratch of the kernel's global passes (None
    otherwise).  All uninitialised: the kernel fills them from the
    rows."""
    xb = _as_batch(x).contiguous()
    _check_kernel_operand(name, xb)
    batch, t, c = xb.shape
    key = (xb.dtype, kv)
    if key not in _LAUNCH_LANES:
        _LAUNCH_LANES[key] = cuda.library(
            "merge_rows").merge_rows_launch_lanes(xb.element_size(), int(kv))
    total = max(1, _next_pow2(t)) * max(2, _next_pow2(c))
    dtypes = (xb.dtype, torch.int32) if kv else (xb.dtype,)
    out = [torch.empty((batch, t * c), dtype=d, device=xb.device)
           for d in dtypes]
    scratch = ([torch.empty((batch, total), dtype=d, device=xb.device)
                for d in dtypes] if total > _LAUNCH_LANES[key]
               else [None] * len(dtypes))
    return xb, out, scratch


def _ptr(x):
    return None if x is None else x.data_ptr()


def merge_sorted_rows(x: torch.Tensor) -> torch.Tensor:
    """Merge t sorted rows into one sorted vector, per batch entry.

    x: (t, c) or (batch, t, c), rows ascending.  Returns (t*c,) or
    (batch, t*c), ascending.  Rows are padded to (pow2, pow2) with the
    sort sentinel and merged by the reference's log2(t) pairwise
    bitonic-merge levels (``_merge_levels`` groups levels into row-group
    blocks, which does not change the compare-exchanges).  A CUDA tensor
    runs the kernel, which pads as it loads the rows and writes only the
    merged real positions (one launch for every padded entry up to
    ``MAX_KERNEL_LANES``); a CPU tensor :func:`merge_sorted_rows_plain`.
    """
    if not x.is_cuda:
        return merge_sorted_rows_plain(x)
    xb, (out,), (scratch,) = _merge_operand("merge_sorted_rows", x, False)
    batch, t, c = xb.shape
    cuda.launch("merge_rows", f"merge_rows_{_SUFFIX[xb.dtype]}",
                xb.data_ptr(), out.data_ptr(), _ptr(scratch), batch, t, c)
    return out[0] if x.dim() == 2 else out


def merge_sorted_rows_argsort_plain(x: torch.Tensor):
    """The plain version of :func:`merge_sorted_rows_argsort`."""
    xb = _as_batch(x)
    flat, ids, run = _padded_slots(xb)
    n = xb.shape[1] * xb.shape[2]
    merged, order = merge_network_block_kv(
        flat, ids.expand(flat.shape[0], -1), run)
    merged, order = merged[:, :n], order[:, :n]
    return (merged[0], order[0]) if x.dim() == 2 else (merged, order)


def merge_sorted_rows_argsort(x: torch.Tensor):
    """Merge t sorted rows carrying the stable permutation.

    x: (t, c) or (batch, t, c), rows ascending.  Returns (merged, order):
    (t*c,) or (batch, t*c) each, ``order`` int32 indices into each batch
    entry's ``x.reshape(-1)`` -- bitwise a stable flat argsort (ties
    resolve by buffer position).  The ids are ``_pad_iota_unique``, so
    every (key, id) pair is distinct.  A CUDA tensor runs the kernel,
    which builds the ids and the padding as it loads the rows; a CPU
    tensor :func:`merge_sorted_rows_argsort_plain`.
    """
    if not x.is_cuda:
        return merge_sorted_rows_argsort_plain(x)
    xb, (out, order), scratch = _merge_operand("merge_sorted_rows_argsort",
                                               x, True)
    batch, t, c = xb.shape
    cuda.launch("merge_rows_kv", f"merge_rows_kv_{_SUFFIX[xb.dtype]}",
                xb.data_ptr(), out.data_ptr(), order.data_ptr(),
                _ptr(scratch[0]), _ptr(scratch[1]), batch, t, c)
    return (out[0], order[0]) if x.dim() == 2 else (out, order)
