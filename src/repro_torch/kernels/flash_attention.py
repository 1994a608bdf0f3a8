"""Blocked causal attention (flash-style online softmax): the LM's prefill.

Counterpart of ``src/repro/kernels/flash_attention.py`` (``pallas_call``
at :105, body ``_fa_kernel`` :31).  The kernels are in
``csrc/flash_attention.cu``: bf16 runs on the tensor cores (``fa_wgmma``:
wgmma products, K/V tiles double-buffered by cp.async), float32 on
the CUDA cores (``fa_simt``).  :func:`flash_attention_plain` is their
plain version, the same online softmax over blocks of keys in torch ops:
scores in float32 with the -1e30 mask, the running (m, l, acc), and
``acc / where(l == 0, 1, l)`` at the end.  GQA maps q head h to kv head
h // (Hq // Hkv); a sliding window keeps keys with kpos > qpos - window;
query positions are right-aligned to the keys (qpos = i + Sk - Sq), as
the reference's kernel has it (it takes no q_offset).

A CUDA tensor launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda

__all__ = ["flash_attention", "flash_attention_plain", "DTYPES",
           "BLOCK_K", "MAX_HEAD_DIM"]

NEG = -1e30
DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The float32 kernel's key tile (csrc/flash_attention.cu fa_simt: 64
# queries a block, 32 keys a step).  The plain version steps over keys
# by the same tile.
BLOCK_K = 32
# head dims the kernels are compiled for, by dtype; another d <= 256 is
# zero-padded to the next one (zero columns add nothing to q.k, and the
# padded output columns are cut off).  The bf16 kernel's wgmma tiles
# take rows of 64 values or more.
HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
             torch.bfloat16: (64, 128, 256)}
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernel's gate, on either device: q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D), one dtype of DTYPES, Hq a multiple of Hkv, 0 < D <=
    MAX_HEAD_DIM."""
    ok = (q.dim() == 4 and k.dim() == 4 and v.shape == k.shape
          and q.dtype in DTYPES and k.dtype == v.dtype == q.dtype
          and k.shape[0] == q.shape[0] and k.shape[3] == q.shape[3]
          and k.shape[1] > 0 and q.shape[1] % k.shape[1] == 0
          and 0 < q.shape[-1] <= MAX_HEAD_DIM)
    if not ok:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype} are outside the kernel's gate (one of "
                         f"float32/bfloat16, Hq a multiple of Hkv, head_dim "
                         f"<= {MAX_HEAD_DIM})")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`flash_attention`, on any device.

    All queries at once, one block of ``BLOCK_K`` keys a step; grouped
    einsums, so K and V are never expanded to Hq heads.
    """
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    sm_scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    qpos = (torch.arange(sq, device=q.device) + (sk - sq))[:, None]
    m = torch.full((b, hkv, g, sq, 1), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kb) * sm_scale
        kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  Returns (B, Hq, Sq, D).

    A CUDA tensor runs the kernel (contiguous, B * Hq <= 65535); a CPU
    tensor runs the plain version.  Operands outside the gate
    (:func:`_check`) raise on either device.
    """
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, window)
    for x in (q, k, v):
        cuda.check_cuda_tensor("flash_attention", x, DTYPES)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {b * hq} > 65535")
    dk = next(h for h in HEAD_DIMS[q.dtype] if h >= d)
    if dk != d:
        pad = (0, dk - d)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    # the bf16 kernel copies rows in 16-byte pieces (cp.async)
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    if sq > 0:
        cuda.launch("flash_attention",
                    f"flash_attention_{_SUFFIX[q.dtype]}",
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, hq, hkv, sq, sk, dk, 1.0 / (d ** 0.5), int(causal),
                    -1 if window is None else int(window))
    return out[..., :d] if dk != d else out
