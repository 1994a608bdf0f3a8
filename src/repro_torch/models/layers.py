"""Basic model layers: RMSNorm, RoPE, gated MLPs, weight init.

Counterpart of ``src/repro/models/layers.py``.  Each function casts where
the reference casts, so a float32 run matches it to rounding and a
bfloat16 run rounds at the same places:

* ``rms_norm`` normalises in float32 and scales by ``1 + scale`` (the
  norm weights start at zero);
* ``rope`` multiplies the activations by float32 cos/sin (torch promotes
  bf16 x f32 to f32, as jnp does) and casts the result back;
* ``gated_mlp``'s GeGLU is the tanh approximation, ``jax.nn.gelu``'s
  default (torch's default is the exact form).

Weights are drawn from an explicit ``torch.Generator`` on an explicit
device; they are not the reference's ``jax.random`` draws (the tests
carry the reference's weights over with ``models.convert``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "gated_mlp", "init_dense", "init_mlp"]


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
