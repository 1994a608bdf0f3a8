"""Attention for prefill and decode.

Counterpart of ``src/repro/models/attention.py``.  Two paths, chosen by
the query length as in the reference:

* ``Sq <= 16`` (decode, tiny prefill): :func:`_dense_rows`, full score
  rows with grouped einsums (K/V never expanded to the q heads), at an
  explicit ``q_offset`` -- decode attends over the whole cache buffer,
  masked by the current position.  The reference computes these rows
  outside any Pallas kernel, and so does the port (plain torch ops).
* otherwise: the flash-attention kernel, ``ops.flash_attention``
  (``csrc/flash_attention.cu`` on the card, its plain version on the
  CPU).  The reference model reaches its Pallas kernel only with
  ``backend="pallas"``; the port always does, so the kernel is on its
  prefill path.  The kernel right-aligns the queries to the keys and
  takes no offset, so a call with ``q_offset != Sk - Sq`` raises (the
  reference's Pallas backend ignores the offset there).

The reference's blockwise ``_chunk_scan`` backend exists for GSPMD
sharding and is not ported (ROADMAP A12).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops

__all__ = ["attention"]

_NEG = -1e30
DENSE_ROWS_MAX_Q = 16


def _dense_rows(q, k, v, q_offset: int, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """Full-row attention for short q (decode / tiny prefill), GQA by
    grouped einsums: q as (B, Hkv, g, Sq, D) against un-expanded K/V."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v)
    return o.reshape(b, hq, sq, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    q_offset: absolute position of q[0] (default right-aligned to k)."""
    sq, sk = q.shape[2], k.shape[2]
    if q_offset is None:
        q_offset = sk - sq
    if sq <= DENSE_ROWS_MAX_Q:
        return _dense_rows(q, k, v, q_offset, causal, window)
    if q_offset != sk - sq:
        raise ValueError(f"attention: {sq} queries at offset {q_offset} over "
                         f"{sk} keys; the flash-attention kernel right-aligns "
                         f"the queries (offset {sk - sq})")
    return ops.flash_attention(q, k, v, causal=causal, window=window)
