"""LSD radix sort: the wide-row sort family.

Counterpart of ``src/repro/kernels/radix.py``.  One kernel with its
plain PyTorch version beside it:

* :func:`radix_sort` -- stable ascending sort of each row of (rows, n),
  any 1 <= n, returning the sorted rows and the int32 stable argsort;
  CUDA source ``csrc/radix_sort.cu``, an onesweep of 8-bit digits (one
  histogram launch, then one launch a pass with decoupled look-back).
  :func:`radix_sort_plain` runs the reference's 4-bit passes in torch
  ops (digit, one-hot, cumsum, exclusive starts, scatter of the
  permutation, regather of the bits).  The stable argsort of a row is
  unique, so the two agree bitwise whatever their digit widths.

Keys go through a monotone bijection into sortable unsigned bits
(:func:`key_to_bits`): int32 ``x ^ 0x80000000``; float32 ``u ^
0x80000000`` when the sign bit is clear and ``~u`` when it is set;
bf16 the 16-bit variant of the float fold in [0, 2^16), so a bf16 key
is a 16-bit key and sorts in half the passes.
Before the passes the bits are folded onto the reference comparator's
equivalence classes (:func:`sort_ready_bits`): every NaN to all ones,
the denormal band and -0.0 onto +0.0.  The sorted keys are the
*original* keys in that order (the plain version gathers them through
the order, the kernel carries them through its passes), so NaN
payloads, -0.0 and denormals keep their bits.

The bits ride in an int32 carrier, as in the reference's kernel: torch
has no unsigned 32-bit arithmetic on the CPU.  ``(bits >> shift) & 15``
is the right digit even for shift 28 (the sign fill is masked off), and
unsigned comparisons are made on ``bits ^ 0x80000000`` as signed ints.
bf16 bits are below 2^16, so their carrier is never negative.
"""
from __future__ import annotations

import torch

from . import cuda
from .bitonic import KEY_DTYPES, _SUFFIX, as_bits

__all__ = ["DEFAULT_RADIX_BITS", "RADIX_KERNEL_BITS", "RADIX_TILE",
           "key_bits", "key_to_bits", "bits_to_key", "sort_ready_bits",
           "pass_positions_plain", "radix_sort", "radix_sort_plain"]

# Digits per counting pass of the reference and the plain version: 16
# bins, 8 passes for 32-bit keys and 4 for bf16.  The cost model counts
# passes of this width (ops.RADIX_BITS).
DEFAULT_RADIX_BITS = 4
# The CUDA kernel's own digit width and tile (csrc/radix_sort.cu kBits,
# kTile): 8-bit digits, 4096 keys a block.  The wrapper sizes the
# kernel's zeroed scratch with them -- a 64-bit look-back status word per
# (tile, digit), the (rows, passes, 256) histogram and a ticket counter
# a pass -- and the kernel refuses a scratch smaller than it needs.
RADIX_KERNEL_BITS = 8
RADIX_TILE = 4096

_I32_MIN = -(1 << 31)


def key_bits(dtype: torch.dtype) -> int:
    """Sort-significant key width in bits: 16 for bf16, 32 for float32
    and int32."""
    if dtype == torch.bfloat16:
        return 16
    if dtype in KEY_DTYPES:
        return 32
    raise TypeError(f"no radix key specialization for dtype {dtype}")


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's 16 bits as int32 in [0, 2^16)."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def key_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Monotone bijection: keys -> sortable bits, in an int32 carrier.

    The *unsigned* order of the carrier's bit patterns is the key order
    (numeric for int32, IEEE-754 total order over bit patterns for
    float32).  Exact: every pattern round-trips through
    :func:`bits_to_key`.  ``.view(torch.uint32)`` (or numpy's uint32
    view) shows the reference's uint32 bits.
    """
    key_bits(x.dtype)
    if x.dtype == torch.int32:
        return x ^ _I32_MIN
    if x.dtype == torch.bfloat16:
        u = _bf16_bits(x)
        return u ^ torch.where(u >= 0x8000, 0xFFFF, 0x8000).to(torch.int32)
    u = x.view(torch.int32)
    return u ^ torch.where(u < 0, -1, _I32_MIN).to(torch.int32)


def bits_to_key(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact inverse of :func:`key_to_bits`.  bits: int32 carrier."""
    key_bits(dtype)
    if dtype == torch.int32:
        return bits ^ _I32_MIN
    if dtype == torch.bfloat16:
        u = bits ^ torch.where(bits >= 0x8000, 0x8000, 0xFFFF).to(torch.int32)
        u = torch.where(u >= 0x8000, u - 0x10000, u)       # as signed 16 bits
        return u.to(torch.int16).view(torch.bfloat16)
    mask = torch.where(bits < 0, _I32_MIN, -1).to(torch.int32)
    return (bits ^ mask).view(torch.float32)


def sort_ready_bits(x: torch.Tensor) -> torch.Tensor:
    """:func:`key_to_bits` folded onto the comparator's classes.

    The reference compares floats flush-to-zero: every denormal of
    either sign equals +-0.0, a contiguous bijected band
    ``[2^(kb-1) - 2^mant, 2^(kb-1) + 2^mant)`` (kb = 32, mant = 23 for
    float32; 16 and 7 for bf16) that folds onto the +0.0 point, and
    every NaN maps to all ones of the key's width (NaNs last, in input
    order).  float32's band test is unsigned, made as a signed test on
    ``bits ^ 0x80000000``.
    """
    bits = key_to_bits(x)
    if x.dtype == torch.int32:
        return bits
    if x.dtype == torch.bfloat16:
        zero, mant, allones = 0x8000, 1 << 7, 0xFFFF
        denorm = (bits >= zero - mant) & (bits < zero + mant)
    else:
        zero, mant, allones = _I32_MIN, 1 << 23, -1
        centred = bits ^ _I32_MIN              # unsigned order, signed ints
        denorm = (centred >= -mant) & (centred < mant)
    bits = torch.where(denorm, torch.full_like(bits, zero), bits)
    return torch.where(torch.isnan(x), torch.full_like(bits, allones), bits)


def pass_positions_plain(bits: torch.Tensor, shift: int,
                         radix_bits: int = DEFAULT_RADIX_BITS
                         ) -> torch.Tensor:
    """Destinations of one stable counting pass over ``(bits >> shift)``.

    bits: (rows, n) int32 in this pass's input order.  The inclusive
    cumsum of the one-hot digit tensor gives each element's rank within
    its bin and, in its last slice, the bin totals; ``position =
    start + rank - 1``.  Returns (rows, n) int32.
    """
    nbins = 1 << radix_bits
    digit = ((bits >> shift) & (nbins - 1)).long()              # (rows, n)
    onehot = digit[:, :, None] == torch.arange(nbins, device=bits.device)
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32)      # inclusive
    totals = ranks[:, -1, :]                                    # (rows, nbins)
    starts = torch.cumsum(totals, dim=1, dtype=torch.int32) - totals
    rank = torch.gather(ranks, 2, digit[:, :, None])[:, :, 0]
    return torch.gather(starts, 1, digit) + rank - 1


def radix_sort_plain(x: torch.Tensor):
    """The plain version of :func:`radix_sort`, on any device.

    The reference's kernel body: only the permutation moves through the
    per-pass scatter, and each pass regathers the bits through it.
    """
    rows, n = x.shape
    if n == 0:
        return x.clone(), torch.zeros((rows, 0), dtype=torch.int32,
                                      device=x.device)
    passes = -(-key_bits(x.dtype) // DEFAULT_RADIX_BITS)
    bits0 = sort_ready_bits(x)
    idx = torch.arange(n, dtype=torch.int32, device=x.device).repeat(rows, 1)
    for p in range(passes):
        cur = torch.gather(bits0, 1, idx.long())
        pos = pass_positions_plain(cur, p * DEFAULT_RADIX_BITS)
        idx = torch.empty_like(idx).scatter_(1, pos.long(), idx)
    return torch.gather(as_bits(x), 1, idx.long()).view(x.dtype), idx


def radix_sort(x: torch.Tensor):
    """Stable row-wise ascending sort.  x: (rows, n), any n >= 1.

    Returns ``(sorted, order)``: ``order`` (rows, n) int32 is the stable
    argsort of each row's canonical bits, and ``sorted`` holds ``x``'s
    keys, bits and all, in that order.  No power-of-two padding.  A CUDA
    tensor runs the kernel (float32, bfloat16 or int32; anything else
    raises): one C call, a memset of the scratch and 1 + key_bits / 8
    kernel launches.  A CPU tensor runs :func:`radix_sort_plain`.
    """
    if x.dim() != 2:
        raise ValueError(f"radix_sort: expected (rows, n), got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return radix_sort_plain(x)
    cuda.check_cuda_tensor("radix_sort", x, KEY_DTYPES)
    rows, n = x.shape
    out = torch.empty_like(x)
    order = torch.empty((rows, n), dtype=torch.int32, device=x.device)
    if rows == 0 or n == 0:
        return out, order
    keys_a = torch.empty_like(x)
    idx_a = torch.empty_like(order)
    bins = 1 << RADIX_KERNEL_BITS
    passes = key_bits(x.dtype) // RADIX_KERNEL_BITS
    nbytes = (rows * -(-n // RADIX_TILE) * bins * 8 + rows * passes * bins * 4
              + passes * 4)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    cuda.launch("radix_sort", f"radix_sort_{_SUFFIX[x.dtype]}",
                x.data_ptr(), out.data_ptr(), order.data_ptr(),
                keys_a.data_ptr(), idx_a.data_ptr(), scratch.data_ptr(),
                nbytes, rows, n)
    return out, order
