"""Mamba-2 SSD (state-space duality) mixer: the chunked scan for
prefill, the O(1) recurrent step for decode.  Used by mamba2-130m and
the jamba hybrid.

Counterpart of ``src/repro/models/ssm.py`` (``MambaState``,
``init_mamba``, ``_causal_conv``, ``ssd_chunked``, ``mamba_block``,
``init_mamba_state``, ``mamba_decode_step``), with the same casts: the
scan runs in float32 whatever the compute dtype, ``dt`` goes through
softplus in float32 (JAX's ``logaddexp(x, 0)`` form), the decay rates
``A_log``, the skip ``D`` and ``dt_bias`` are float32 parameters.

Chunked SSD (arXiv:2405.21060 §6): within a chunk the recurrence is
expanded as a masked quadratic form, across chunks a short recurrence
carries the (heads, head_dim, d_state) state.  The reference writes the
chunk contractions as three-operand einsums and scans the chunks with
``lax.scan``; here each contraction is a pairwise ``matmul`` in the
order that keeps the intermediates small (their shapes are in the
comments: a wrong order would build (B, nc, q, q, H, P)), the chunks
are a Python loop, and the intra-chunk decay masks its exponent before
the exp, so that its gradient stays finite where the reference's is
NaN (ROADMAP C19).  No hand kernel: the reference runs none
here either.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from .layers import init_dense, rms_norm

__all__ = ["MambaState", "init_mamba", "mamba_block", "mamba_block_tp",
           "mamba_decode_step", "init_mamba_state", "ssd_chunked"]


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, conv_width-1, conv_dim)
    ssm: torch.Tensor    # (B, H, head_dim, d_state), float32


def _conv_dim(d_inner: int, s: SSMConfig) -> int:
    return d_inner + 2 * s.d_state  # x, B, C go through the causal conv


def init_mamba(generator: torch.Generator, d: int, s: SSMConfig,
               dtype: torch.dtype, device):
    """One mixer's weights, the reference's shapes and scales; the decay
    rates log(linspace(1, 16, H)), the skip 1 and ``dt_bias``
    softplus^-1(0.01) in float32."""
    di, nh = s.d_inner(d), s.n_heads(d)
    cd = _conv_dim(di, s)
    proj_out = 2 * di + 2 * s.d_state + nh  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": init_dense(generator, (d, proj_out), dtype, device),
        "conv_w": init_dense(generator, (s.conv_width, cd), dtype, device,
                             scale=s.conv_width ** -0.5),
        "conv_b": torch.zeros((cd,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.full((nh,), -4.6, **f32),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": init_dense(generator, (di, d), dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (torch's own switches to x above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width W.  x: (B, S, C), w: (W, C).

    Returns (y, new_state): y = silu(conv + b) in x's dtype, and the
    last W-1 inputs (the decode state)."""
    width, seq = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + seq] * w[i][None, None] for i in range(width))
    new_state = xp[:, xp.shape[1] - (width - 1):]
    return F.silu((y + b[None, None]).float()).to(x.dtype), new_state


def ssd_chunked(x, dt, a_neg, b_in, c_in, d_skip, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, H, P) inputs; dt: (B, S, H) positive step sizes; a_neg:
    (H,) negative decay rates; b_in, c_in: (B, S, N) (one group, shared
    over heads); d_skip: (H,).  Returns (y (B, S, H, P) in x's dtype,
    final_state (B, H, P, N) float32).

    Where ``chunk`` does not divide S the rows are padded with zeros, as
    in the reference: a pad row's dt is 0, so its decay is exp(0) = 1
    and its update 0, and the final state is the one after the last
    real row.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc, q = (s + pad) // chunk, chunk

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_in.reshape(bsz, nc, q, n).float()
    cc = c_in.reshape(bsz, nc, q, n).float()

    da = dtc * a_neg[None, None, None, :]            # (B, nc, q, H) <= 0
    cum = torch.cumsum(da, dim=2)                    # inclusive
    xdt = xc.float() * dtc[..., None]                # (B, nc, q, H, P)

    # ---- intra-chunk quadratic form --------------------------------------
    # y_intra[i] = sum_j cb[i, j] decay[i, j, h] xdt[j, h]: first the
    # (B, nc, q_i, q_j, H) weights cb * decay, then one batched product
    # over j per (chunk, head)
    # The exponent is masked before the exp: above the diagonal li - lj
    # > 0 grows with the chunk and overflows at full width, and the
    # reference's where(mask, exp(li - lj), 0) then has the gradient
    # 0 * inf = NaN there (ROADMAP C19).  The values are the same.
    li = cum[:, :, :, None, :]                       # i index -> axis 2
    lj = cum[:, :, None, :, :]                       # j index -> axis 3
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], li - lj,
                                  -math.inf))        # (B, nc, q_i, q_j, H)
    cb = cc @ bc.transpose(-1, -2)                   # (B, nc, q_i, q_j)
    # in place where nothing differentiates it (exp keeps its output)
    wts = (decay * cb[..., None] if decay.requires_grad
           else decay.mul_(cb[..., None])).permute(0, 1, 4, 2, 3)
    del decay
    y_intra = wts @ xdt.permute(0, 1, 3, 2, 4)       # (B, nc, H, q_i, P)
    del wts
    y_intra = y_intra.permute(0, 1, 3, 2, 4)         # (B, nc, q, H, P)

    # ---- chunk-boundary states ---------------------------------------------
    # states[h, p, n] = sum_q (decay_out[q, h] xdt[q, h, p]) bc[q, n]
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)   # (B, nc, q, H)
    u = (xdt * decay_out[..., None]).permute(0, 1, 3, 4, 2)  # (B,nc,H,P,q)
    states = u @ bc[:, :, None]                      # (B, nc, H, P, N)
    total = torch.exp(cum[:, :, -1, :])              # (B, nc, H)

    # ---- inter-chunk recurrence (short loop over nc) ---------------------
    if init_state is None:
        st = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
    else:
        st = init_state.float()
    prev = []
    for c in range(nc):
        prev.append(st)                              # the state BEFORE chunk c
        st = st * total[:, c, :, None, None] + states[:, c]
    st_prev = torch.stack(prev, dim=1)               # (B, nc, H, P, N)

    # y_inter[q, h, p] = (sum_n cc[q, n] st_prev[h, p, n]) exp(cum[q, h])
    y_inter = cc[:, :, None] @ st_prev.transpose(-1, -2)   # (B,nc,H,q,P)
    y_inter = y_inter.permute(0, 1, 3, 2, 4) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter) + xc.float() * d_skip[None, None, None, :, None]
    y = y.reshape(bsz, s + pad, h, p)[:, :s]
    return y.to(x.dtype), st


def mamba_block(params, x: torch.Tensor, s: SSMConfig,
                state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, MambaState]:
    """The Mamba-2 mixer.  x: (B, S, d) -> ((B, S, d), the new state).

    One token with a state is the recurrent decode step; anything else
    the chunked scan from ``state`` (zeros when None)."""
    d = x.shape[-1]
    di, nh, ns = s.d_inner(d), s.n_heads(d), s.d_state
    proj = x @ params["in_proj"]
    z, xi, b_in, c_in, dt = torch.split(proj, [di, di, ns, ns, nh], dim=-1)
    y, new = _mix(z, xi, b_in, c_in, dt, params["conv_w"], params["conv_b"],
                  params["A_log"], params["D"], params["dt_bias"], s, state,
                  lambda v: rms_norm(v, params["norm_scale"]))
    return y @ params["out_proj"], new


def _mix(z, xi, b_in, c_in, dt, conv_w, conv_b, a_log, d_skip, dt_bias,
         s: SSMConfig, state: Optional[MambaState], norm):
    """The mixer between the projections, on the heads of ``xi`` (all of
    them, or a rank's under tensor parallelism): the causal conv of x,
    B and C, the SSD scan (or the decode step), the gate and ``norm``.
    Returns (the (B, S, heads * head_dim) rows for the out projection,
    the new state)."""
    bsz, seq, dl = xi.shape
    nh, ns = dt.shape[-1], b_in.shape[-1]
    conv_in = torch.cat([xi, b_in, c_in], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, conv_w, conv_b, None if state is None else state.conv)
    xi, b_in, c_in = torch.split(conv_out, [dl, ns, ns], dim=-1)

    dt = _softplus(dt.float() + dt_bias[None, None])
    a_neg = -torch.exp(a_log)
    if seq == 1 and state is not None:
        # O(1) recurrent decode: h' = h exp(dt A) + B dt x;  y = C h' + D x
        xh = xi.reshape(bsz, nh, s.head_dim).float()      # (B, H, P)
        da = torch.exp(dt[:, 0] * a_neg[None, :])         # (B, H)
        xdt = xh * dt[:, 0, :, None]                      # (B, H, P)
        upd = xdt[..., None] * b_in[:, 0].float()[:, None, None, :]
        ssm_state = state.ssm * da[:, :, None, None] + upd  # (B, H, P, N)
        cvec = c_in[:, 0].float()[:, None, :, None]       # (B, 1, N, 1)
        y = ((ssm_state @ cvec)[..., 0]
             + xh * d_skip[None, :, None])[:, None]       # (B, 1, H, P)
        y = y.to(xi.dtype)
    else:
        y, ssm_state = ssd_chunked(
            xi.reshape(bsz, seq, nh, s.head_dim), dt, a_neg, b_in, c_in,
            d_skip, s.chunk, None if state is None else state.ssm)

    y = y.reshape(bsz, seq, dl)
    y = norm(y * F.silu(z.float()).to(y.dtype))
    return y, MambaState(conv_state, ssm_state)


def mamba_block_tp(params, h: torch.Tensor, s: SSMConfig, par,
                   state: Optional[MambaState] = None
                   ) -> Tuple[torch.Tensor, MambaState]:
    """The mixer with its heads split over 'model': this rank's heads
    [r H/m, (r+1) H/m) and their channels, B and C whole.

    ``h``: (B, S, d) entered into the region (``Par.enter``).  The rules
    split ``in_proj`` and ``conv_w`` into contiguous column blocks that
    cut across the z | x | B | C | dt segments, so both are gathered
    whole over 'model' (``gather_to``) and this rank's columns picked;
    the replicated per-head parameters are sliced after ``copy_to``; the
    gated norm sums its squares over the ranks; ``out_proj``'s rows are
    this rank's channels.  ``state``: this rank's SSM heads and the
    whole conv state (the caller gathers and re-splits the cache's
    channel shards).  Returns (this rank's partial (B, S, d), the new
    state: the rank's SSM heads and its conv channels x | B | C)."""
    from ..sharding.parallel import copy_to, gather_to, reduce_from
    d = h.shape[-1]
    di, nh, ns, hp = s.d_inner(d), s.n_heads(d), s.d_state, s.head_dim
    if nh % par.m:
        raise ValueError(f"{nh} SSM heads do not split over a {par.m}-way "
                         f"'model' axis")
    hl = nh // par.m
    lo, hi = par.rank * hl, (par.rank + 1) * hl
    ch = torch.arange(lo * hp, hi * hp, device=h.device)
    bc = torch.arange(di, di + 2 * ns, device=h.device)
    cols = torch.cat([ch, di + ch, di + bc,
                      2 * di + 2 * ns + torch.arange(lo, hi, device=h.device)])
    w_in = gather_to(par.w(params["in_proj"]), 1, par.group)[:, cols]
    conv_ch = torch.cat([ch, bc])
    conv_w = gather_to(par.w(params["conv_w"]), 1, par.group)[:, conv_ch]
    rep = {n: copy_to(par.w(params[n]), par.group)
           for n in ("conv_b", "A_log", "D", "dt_bias", "norm_scale")}
    dl = hl * hp
    z, xi, b_in, c_in, dt = torch.split(h @ w_in, [dl, dl, ns, ns, hl],
                                        dim=-1)
    scale = rep["norm_scale"][lo * hp:hi * hp]

    def norm(v, eps: float = 1e-6):
        vf = v.float()
        # every rank's channels read the sum: the backward sums too
        ss = copy_to(reduce_from((vf * vf).sum(dim=-1, keepdim=True),
                                 par.group), par.group)
        return ((vf * torch.rsqrt(ss / di + eps))
                * (1.0 + scale.float())).to(v.dtype)

    y, new = _mix(z, xi, b_in, c_in, dt, conv_w, rep["conv_b"][conv_ch],
                  rep["A_log"][lo:hi], rep["D"][lo:hi],
                  rep["dt_bias"][lo:hi], s, state, norm)
    return y @ par.w(params["out_proj"]), new


def init_mamba_state(batch: int, d: int, s: SSMConfig,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> MambaState:
    di = s.d_inner(d)
    return MambaState(
        conv=torch.zeros((batch, s.conv_width - 1, _conv_dim(di, s)),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, s.n_heads(d), s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))


def mamba_decode_step(params, x: torch.Tensor, s: SSMConfig,
                      state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One token's recurrent step.  x: (B, 1, d)."""
    return mamba_block(params, x, s, state=state)
