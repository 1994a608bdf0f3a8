"""Basic model layers: RMSNorm, RoPE, gated MLPs, weight init, the
chunked cross-entropy.

Counterpart of ``src/repro/models/layers.py``.  Each function casts where
the reference casts, so a float32 run matches it to rounding and a
bfloat16 run rounds at the same places:

* ``rms_norm`` normalises in float32 and scales by ``1 + scale`` (the
  norm weights start at zero);
* ``rope`` multiplies the activations by float32 cos/sin (torch promotes
  bf16 x f32 to f32, as jnp does) and casts the result back;
* ``gated_mlp``'s GeGLU is the tanh approximation, ``jax.nn.gelu``'s
  default (torch's default is the exact form);
* ``chunked_cross_entropy`` takes the logits in float32 chunk by chunk,
  as the reference does, and recomputes each chunk's logits in the
  backward pass (see its docstring).

Weights are drawn from an explicit ``torch.Generator`` on an explicit
device; they are not the reference's ``jax.random`` draws (the tests
carry the reference's weights over with ``models.convert``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["rms_norm", "rope", "gated_mlp", "init_dense", "init_mlp",
           "chunked_cross_entropy", "cross_entropy_sums"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
         ) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freq[None, :]       # (S, h)
        ang = ang[None, :, None, :]                            # 1,S,1,h
    else:
        ang = positions[..., None].float() * freq
        ang = ang[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    if act == "geglu":
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    else:
        h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def init_dense(generator: torch.Generator, shape, dtype: torch.dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale^2) weights, drawn in float32 then cast, as the
    reference draws them; ``scale`` defaults to fan_in ** -0.5."""
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype: torch.dtype,
             device):
    return {"w_gate": init_dense(generator, (d, ff), dtype, device),
            "w_up": init_dense(generator, (d, ff), dtype, device),
            "w_down": init_dense(generator, (ff, d), dtype, device)}


def _chunk_loss(x: torch.Tensor, w_unembed: torch.Tensor,
                labels: torch.Tensor, vocab_size: Optional[int]):
    """One chunk's (summed loss, count of labelled positions), float32."""
    v = w_unembed.shape[1]
    logits = (x @ w_unembed).float()
    if vocab_size is not None and vocab_size < v:
        pad_mask = torch.arange(v, device=x.device) >= vocab_size
        logits = torch.where(pad_mask, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          labels.clamp_min(0).long()[..., None])[..., 0]
    valid = labels >= 0
    return (torch.where(valid, lse - picked, 0.0).sum(),
            valid.float().sum())


def _chunk_loss_vocab_parallel(x: torch.Tensor, w_unembed: torch.Tensor,
                               labels: torch.Tensor,
                               vocab_size: Optional[int], par):
    """:func:`_chunk_loss` with the vocabulary split over 'model': this
    rank's ``w_unembed`` columns are [rank * v, (rank + 1) * v); the
    log-sum-exp's maximum and sum and the labels' logits are reduced
    over the ranks (``x`` entered the region with ``Par.enter``)."""
    from ..sharding.parallel import all_reduce_, reduce_from
    v = w_unembed.shape[1]
    lo = par.rank * v
    logits = (x @ w_unembed).float()
    col = lo + torch.arange(v, device=x.device)
    if vocab_size is not None:
        logits = torch.where(col >= vocab_size, -1e30, logits)
    mx = all_reduce_(logits.detach().amax(dim=-1), par.group,
                     torch.distributed.ReduceOp.MAX)
    se = reduce_from(torch.exp(logits - mx[..., None]).sum(dim=-1),
                     par.group)
    lse = torch.log(se) + mx
    rel = labels.long() - lo
    mine = (rel >= 0) & (rel < v)
    picked = torch.gather(logits, -1, rel.clamp(0, v - 1)[..., None])[..., 0]
    picked = reduce_from(torch.where(mine, picked, 0.0), par.group)
    valid = labels >= 0
    return (torch.where(valid, lse - picked, 0.0).sum(),
            valid.float().sum())


def cross_entropy_sums(x: torch.Tensor, w_unembed: torch.Tensor,
                       labels: torch.Tensor, chunk: int = 512,
                       vocab_size: Optional[int] = None, par=None):
    """(summed loss, labelled count) of :func:`chunked_cross_entropy`,
    chunk by chunk; with ``par`` on, the vocabulary split over 'model'
    (:func:`_chunk_loss_vocab_parallel`)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or w_unembed.requires_grad)
    fn = _chunk_loss
    extra = ()
    if par is not None and par.on:
        fn, extra = _chunk_loss_vocab_parallel, (par,)
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        args = (x[:, lo:hi], w_unembed, labels[:, lo:hi], vocab_size) + extra
        if grad:
            part, n = checkpoint(fn, *args, use_reentrant=False)
        else:
            part, n = fn(*args)
        total = total + part
        count = count + n
    return total, count


def chunked_cross_entropy(x: torch.Tensor, w_unembed: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 512,
                          vocab_size: Optional[int] = None) -> torch.Tensor:
    """Token-mean CE without materializing (B, S, V) logits.

    x: (B, S, d) final hidden states; w_unembed: (d, V_padded); labels:
    (B, S) int, -1 = ignore.  The sequence goes in chunks of ``chunk``
    positions, each reduced at once; vocab rows past ``vocab_size`` are
    masked to -1e30.  Where gradients are on, each chunk runs under
    ``torch.utils.checkpoint``: eager autograd would otherwise keep
    every chunk's (B, chunk, V) float32 logits for the backward pass
    (2.1 GB a chunk at gemma-2b's 256,000 vocab and 4 x 512 tokens),
    which undoes the chunking; so only one chunk's logits live at a
    time, forward or backward.
    """
    total, count = cross_entropy_sums(x, w_unembed, labels, chunk,
                                      vocab_size)
    return total / torch.clamp_min(count, 1.0)
