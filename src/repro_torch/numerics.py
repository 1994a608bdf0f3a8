"""float32 arithmetic as the reference's jitted CPU programs round it.

XLA rewrites some of the reference's float32 expressions before it runs
them: a division by a constant becomes a product with its float32
reciprocal, and ``a * b + c`` a fused multiply-add.  The port replays
both where its results must equal the reference's bit for bit: the
sample and Round-2 indices of SMMS and Terasort
(``core/boundaries.py``, ``core/terasort.py``), Algorithm 1's
interpolation, and the int8 KV cache's scales (``models/model.py``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["float32_reciprocal", "fma_float32"]


def float32_reciprocal(s: int, device) -> torch.Tensor:
    """float32(1/s) as a 0-d tensor on ``device``: the reciprocal that
    XLA multiplies by in place of the reference's division by the
    constant s (ROADMAP C18).  It is rounded once, on the host, and
    filled in on the device, so the card and the CPU multiply by the
    same float32 (a division on the card could take a reciprocal of its
    own, C6)."""
    return torch.full((), float(np.float32(1) / np.float32(s)),
                      dtype=torch.float32, device=device)


def fma_float32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c``.

    XLA contracts the reference's ``fp + q * df`` into a fused
    multiply-add on the CPU; torch rounds twice.  The product of two
    float32 values is exact in float64; the float64 sum is rounded to
    odd (a TwoSum error term decides), and rounding that to float32
    gives the fused result exactly (53 >= 2 * 24 + 2 bits).
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()
