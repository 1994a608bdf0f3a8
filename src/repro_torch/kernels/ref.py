"""Plain oracles for the port's kernels (the tests' semantic contract).

Counterpart of ``src/repro/kernels/ref.py``.  These are library calls
with the reference's comparator semantics (denormals fold to zero,
ties keep input order); the port's main path never calls them.
"""
from __future__ import annotations

import torch

from .bitonic import ftz

__all__ = ["sort_ref", "sort_kv_ref", "merge_sorted_rows_kv_ref",
           "searchsorted_ref", "sort_partition_ref", "sort_partition_kv_ref"]


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ascending sort, as ``jnp.sort`` orders it. x: (..., n)."""
    order = torch.sort(ftz(x), dim=-1, stable=True).indices
    return torch.gather(x, -1, order)


def _stable_take(keys: torch.Tensor, values: torch.Tensor):
    """keys (rows, n), values (rows, n, ...) in stable key order."""
    order = torch.sort(ftz(keys), dim=-1, stable=True).indices
    rows = torch.arange(keys.shape[0])[:, None]
    return keys[rows, order], values[rows, order]


def sort_kv_ref(keys: torch.Tensor, values: torch.Tensor):
    """Stable sort of each row of keys (rows, n), values riding along."""
    return _stable_take(keys, values)


def merge_sorted_rows_kv_ref(keys: torch.Tensor, values: torch.Tensor):
    """keys (batch, t, c), values (batch, t, c, ...) -> each batch
    entry's flat rows in stable key order."""
    batch, t, c = keys.shape
    return _stable_take(keys.reshape(batch, t * c),
                        values.reshape(batch, t * c, *values.shape[3:]))


def searchsorted_ref(sorted_arr: torch.Tensor, queries: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Row-wise ``jnp.searchsorted`` with int32 results."""
    return torch.searchsorted(ftz(sorted_arr).contiguous(),
                              ftz(queries).contiguous(), side=side,
                              out_int32=True)


def sort_partition_ref(x: torch.Tensor, queries: torch.Tensor):
    """x (rows, m), queries (rows, nq) -> (sorted rows, left cuts)."""
    xs = sort_ref(x)
    return xs, searchsorted_ref(xs, queries, side="left")


def sort_partition_kv_ref(keys: torch.Tensor, queries: torch.Tensor):
    """keys (rows, m), queries (rows, nq) -> (sorted keys, the stable
    argsort (int32), left cuts)."""
    order = torch.sort(ftz(keys), dim=-1, stable=True).indices
    ks = torch.gather(keys, -1, order)
    return (ks, order.to(torch.int32),
            searchsorted_ref(ks, queries, side="left"))
