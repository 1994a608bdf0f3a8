"""Plain oracles for the port's kernels (the tests' semantic contract).

Counterpart of ``src/repro/kernels/ref.py``.  These are library calls
with the reference's comparator semantics (denormals fold to zero,
ties keep input order), and plain-torch attention; the port's main
path never calls them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .bitonic import ftz

__all__ = ["sort_ref", "sort_kv_ref", "merge_sorted_rows_kv_ref",
           "searchsorted_ref", "sort_partition_ref", "sort_partition_kv_ref",
           "bucketize_ref", "attention_ref"]


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


def bucketize_ref(keys: torch.Tensor, boundaries: torch.Tensor, t: int):
    """Bucket ids and the per-bucket histogram.  keys: (n,); boundaries:
    (t-1,) ascending interior boundaries; id = the number of boundaries
    <= key (buckets are [b_k, b_{k+1})).  Returns (ids, counts), int32."""
    ids = searchsorted_ref(boundaries, keys, side="right")
    buckets = torch.arange(t, device=keys.device)
    counts = (ids[:, None] == buckets[None, :]).sum(0)
    return ids, counts.to(torch.int32)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with GQA and an optional sliding window.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0; queries
    right-aligned to the keys.  Key j is visible to query i iff
    j <= i (causal) and i - window < j (window).  Scores in q's dtype,
    the softmax in float32, the probabilities back in q's dtype.
    """
    d = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(g, dim=1)
    vx = v.repeat_interleave(g, dim=1)
    scale = torch.sqrt(torch.tensor(float(d), device=q.device)).to(q.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kx) / scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores.float(), float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vx)
