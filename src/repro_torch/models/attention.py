"""Attention for training, prefill and decode.

Counterpart of ``src/repro/models/attention.py``.  Two paths, chosen by
the query length as in the reference, and for long queries two
backends:

* ``Sq <= 16`` (decode, tiny prefill): :func:`_dense_rows`, full score
  rows with grouped einsums (K/V never expanded to the q heads), at an
  explicit ``q_offset`` -- decode attends over the whole cache buffer,
  masked by the current position.  The reference computes these rows
  outside any Pallas kernel, and so does the port (plain torch ops).
* otherwise, ``backend="flash"`` (the default, and the only backend
  the model's prefill uses): the flash-attention kernel,
  ``ops.flash_attention`` (``csrc/flash_attention.cu`` on the card, its
  plain version on the CPU).  The reference model reaches its Pallas
  kernel only with ``backend="pallas"``; the port always does, so the
  kernel is on its prefill path.  The kernel right-aligns the queries
  to the keys and takes no offset, so a call with ``q_offset != Sk -
  Sq`` raises (the reference's Pallas backend ignores the offset
  there).
* ``backend="blockwise"``: the reference's default backend, plain
  torch -- a loop over ``q_chunk`` query chunks, each an online softmax
  (:func:`_chunk_scan`) over ``block_k`` blocks of only its causal key
  prefix (from the window's first block), at any ``q_offset``.  It is
  the tests' counterpart of the reference's own at a tight tolerance,
  and ``chip_smoke.py`` holds the kernel against it at full width.

Training goes through the kernel too.  The kernel is a foreign call
with no derivative, so where an operand requires a gradient (and
gradients are on) ``attention`` calls :class:`FlashAttentionFn`: its
forward is the kernel, its backward recomputes :func:`_blockwise` under
autograd and returns dq, dk and dv.  The reference has no Pallas
backward and differentiates that same blockwise scan (its default
backend), so the gradient is the reference's; the recompute is what
its ``jax.checkpoint`` does anyway.  Without gradients the serving path
is unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = ["attention", "FlashAttentionFn"]

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


def _chunk_scan(q_c, k_pfx, v_pfx, q_offset: int, window: Optional[int],
                block_k: int, causal: bool) -> torch.Tensor:
    """Online softmax over ``block_k`` key blocks for one query chunk
    (its key prefix only), GQA by grouped einsums, in float32: the
    running max, sum and weighted values, rescaled block by block."""
    b, hq, qc, d = q_c.shape
    hkv, sk = k_pfx.shape[1], k_pfx.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    nkb = -(-sk // block_k)
    pad = nkb * block_k - sk
    if pad:
        k_pfx = F.pad(k_pfx, (0, 0, 0, pad))
        v_pfx = F.pad(v_pfx, (0, 0, 0, pad))
    qg = q_c.reshape(b, hkv, g, qc, d)
    qpos = torch.arange(qc, device=q_c.device)[:, None] + q_offset
    f32 = dict(dtype=torch.float32, device=q_c.device)
    m = torch.full((b, hkv, g, qc, 1), _NEG, **f32)
    l_sum = torch.zeros((b, hkv, g, qc, 1), **f32)
    acc = torch.zeros((b, hkv, g, qc, d), **f32)
    for blk in range(nkb):
        keys = slice(blk * block_k, (blk + 1) * block_k)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg,
                         k_pfx[:, :, keys]).float() * scale
        kpos = blk * block_k + torch.arange(block_k,
                                            device=q_c.device)[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgqc,bkcd->bkgqd", p,
                                         v_pfx[:, :, keys].float())
        m = m_new
    out = (acc / torch.where(l_sum == 0, 1.0, l_sum)).to(q_c.dtype)
    return out.reshape(b, hq, qc, d)


def _blockwise(q, k, v, q_offset: int, causal: bool, window: Optional[int],
               q_chunk: int, block_k: int) -> torch.Tensor:
    """The reference's blockwise backend: per query chunk, the static
    causal key prefix (keys past the chunk's last query are masked
    anyway) from the block-aligned start of its window."""
    sq, sk = q.shape[2], k.shape[2]
    q_chunk = min(q_chunk, sq)
    outs = []
    for lo in range(0, sq, q_chunk):
        hi = min(sq, lo + q_chunk)
        kv_hi = min(sk, q_offset + hi) if causal else sk
        kv_lo = 0
        if window is not None:
            kv_lo = max(0, q_offset + lo - window + 1)
            kv_lo = (kv_lo // block_k) * block_k
        outs.append(_chunk_scan(q[:, :, lo:hi], k[:, :, kv_lo:kv_hi],
                                v[:, :, kv_lo:kv_hi], q_offset + lo - kv_lo,
                                window, block_k, causal))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel forward, the blockwise scan's gradient backward.

    ``apply(q, k, v, causal, window, q_chunk, block_k)``: queries
    right-aligned to the keys, as the kernel takes them.  The backward
    recomputes :func:`_blockwise` at ``q_chunk`` / ``block_k`` (the
    reference trains at its defaults, 2048 / 2048) from the saved
    operands and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                q_chunk: int, block_k: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_chunk, block_k)
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        causal, window, q_chunk, block_k = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _blockwise(*qkv, k.shape[2] - q.shape[2], causal, window,
                             q_chunk, block_k)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad_out)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: Optional[int] = None, backend: str = "flash",
              q_chunk: int = 2048, block_k: int = 2048) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    q_offset: absolute position of q[0] (default right-aligned to k).
    backend: "flash" (the kernel; under autograd
    :class:`FlashAttentionFn`, whose backward runs the blockwise scan at
    ``q_chunk`` and ``block_k``) or "blockwise" (plain torch); at most
    16 queries take the dense rows either way."""
    if backend not in ("flash", "blockwise"):
        raise ValueError(f"attention: unknown backend {backend!r}; "
                         f"'flash' or 'blockwise'")
    sq, sk = q.shape[2], k.shape[2]
    if q_offset is None:
        q_offset = sk - sq
    if sq <= DENSE_ROWS_MAX_Q:
        return _dense_rows(q, k, v, q_offset, causal, window)
    if backend == "blockwise":
        return _blockwise(q, k, v, q_offset, causal, window, q_chunk,
                          block_k)
    if q_offset != sk - sq:
        raise ValueError(f"attention: {sq} queries at offset {q_offset} over "
                         f"{sk} keys; the flash-attention kernel right-aligns "
                         f"the queries (offset {sk - sq})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_chunk,
                                      block_k)
    return ops.flash_attention(q, k, v, causal=causal, window=window)
