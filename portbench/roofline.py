"""Peaks of the card and the bytes of each timed operation.

Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W): 3.35 TB/s of HBM3,
989 TFLOP/s bf16.  A share of a roofline is the least time the bytes
need at the peak over the device time the operation took, in percent.

Bytes are the operation's own, from its shapes: each input byte read
once and each output byte written once, counting only valid entries
(padding and sentinel slots are not counted).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOP_PER_S", "pair_sort_bytes",
           "merge_bytes", "roofline_pct", "valid_count", "row_bytes"]

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

ORDER_BYTES = 4     # the int32 order a merge hands back


def pair_sort_bytes(valid: int, key_bytes: int, value_row_bytes: int) -> int:
    """A stable sort of keys carrying values (``ops.sort_kv``): keys and
    value rows read once, sorted keys and permuted value rows written
    once."""
    return int(valid) * 2 * (int(key_bytes) + int(value_row_bytes))


def merge_bytes(valid: int, key_bytes: int) -> int:
    """A merge of sorted rows that hands back the merged keys and the
    int32 order (``fused.rank_merge``): keys in, keys out, order out."""
    return int(valid) * (2 * int(key_bytes) + ORDER_BYTES)


def roofline_pct(nbytes: float, device_s: float) -> Optional[float]:
    """The bytes' least time at the HBM peak over the device time, in
    percent; None when nothing was timed."""
    if not nbytes or not device_s or device_s <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / device_s


def row_bytes(values: torch.Tensor, lead: int) -> int:
    """Bytes of one value row of ``values`` past its ``lead`` leading
    dimensions."""
    n = 1
    for d in values.shape[lead:]:
        n *= int(d)
    return n * values.element_size()


def valid_count(keys: torch.Tensor) -> torch.Tensor:
    """The number of real keys in a buffer, as a 0-d int64 tensor on the
    keys' device (no host read): floats other than the +inf pad
    sentinel, integers other than the int32 mask sentinel."""
    if keys.dtype.is_floating_point:
        return (keys != float("inf")).sum()
    return (keys != torch.iinfo(keys.dtype).max).sum()
