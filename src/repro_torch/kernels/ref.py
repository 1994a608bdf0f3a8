"""Plain oracles for the port's kernels (the tests' semantic contract).

Counterpart of ``src/repro/kernels/ref.py``.  These are library calls
with the reference's comparator semantics (denormals fold to zero,
ties keep input order); the port's main path never calls them.
"""
from __future__ import annotations

import torch

from .bitonic import ftz

__all__ = ["sort_ref", "searchsorted_ref"]


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ascending sort, as ``jnp.sort`` orders it. x: (..., n)."""
    order = torch.sort(ftz(x), dim=-1, stable=True).indices
    return torch.gather(x, -1, order)


def searchsorted_ref(sorted_arr: torch.Tensor, queries: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Row-wise ``jnp.searchsorted`` with int32 results."""
    return torch.searchsorted(ftz(sorted_arr).contiguous(),
                              ftz(queries).contiguous(), side=side,
                              out_int32=True)
