"""Decoder LM: init / train forward and loss / cache / prefill / decode.

Counterpart of ``src/repro/models/model.py`` (``init_params``,
``params_shape``, ``forward``, ``train_loss``, ``init_cache``,
``prefill``, ``decode_step``, ``_attn_sub``, ``_ffn_sub``,
``_apply_period_train``, ``_quant_rows``, ``_embed_in``) for every
configuration of the reference.  A layer is attention (global or local)
or a Mamba-2 mixer (``cfg.kind(pos) == "mamba"``: ``ln1`` and
``mamba``, the mixer of ``models/ssm.py``); either is followed by the
dense MLP or, where ``cfg.is_moe(pos)``, by ``ln2`` and ``moe``:
``models/moe.py:moe_layer`` in its config's dense dispatch mode, one
dispatch group (the reference's group count without a mesh).  What
differs:

* Parameters are plain dictionaries of tensors with the reference's
  names.  The reference stacks each in-period position's weights on a
  leading ``n_periods`` axis and scans the period with ``lax.scan``;
  here ``params["periods"]`` is a list of ``n_periods`` dicts
  ``{str(pos): block}`` and the period is a Python loop (torch runs
  eagerly; there is nothing to keep small).  ``models/convert.py``
  unstacks the reference's parameters into this layout.
* No ``ShardingRules``: with no mesh the reference's rules are the
  identity (``src/repro/sharding/specs.py:58-60``), and one card has no
  mesh.
* The KV cache is written in place: prefill writes positions [0, s),
  a decode step position ``pos``.  That gives the values of the
  reference's ``CACHE_WRITE="select"`` masked write (every other slot
  keeps its value), without a copy of the cache per layer per step.
  The cache is the compute dtype, or with ``kv_quant`` int8 rows and
  float32 row scales (:func:`_quant_rows`), dequantized for the decode
  step's attention as the reference does.  A mamba layer's cache is its
  conv and SSM state, replaced at every call.
* Prefill attends through the flash-attention kernel
  (``models/attention.py``); decode through the dense rows.
* Training (:func:`forward`, :func:`train_loss`) attends through the
  same kernel, differentiated by ``attention.FlashAttentionFn``.  The
  reference wraps its scanned period in ``jax.checkpoint``; here
  ``remat`` wraps each period's call in ``torch.utils.checkpoint``
  (non-reentrant): ``"full"`` keeps only the period's input, ``"dots"``
  also the outputs of the matmuls without batch dimensions (``aten.mm``
  / ``aten.addmm``: the projections; JAX's
  ``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.
  The MoE and mamba layers are the serving modules, run without state.

The vision front end (pixtral-12b) is the reference's stub: ``embeds``
(B, n_front, frontend_dim) handed to :func:`prefill` go through
``frontend_proj`` and are prepended to the token rows.  The audio front
end (musicgen-medium) is a stub in the reference, whose model branches
only on ``"vision"``: it consumes audio codes as tokens, and so does the
port.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..numerics import fma_float32
from . import moe
from .attention import attention
from .layers import (chunked_cross_entropy, gated_mlp, init_dense, init_mlp,
                     rms_norm, rope)
from .ssm import MambaState, init_mamba, init_mamba_state, mamba_block

__all__ = ["init_params", "params_shape", "forward", "train_loss",
           "init_cache", "prefill", "decode_step", "REMAT"]

REMAT = ("full", "dots", "none")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(generator: torch.Generator, cfg: ArchConfig, pos: int,
                device):
    d, dtype = cfg.d_model, cfg.param_dtype
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)  # noqa: E731
    p: Dict[str, Any] = {"ln1": zeros()}
    if cfg.kind(pos) == "mamba":
        p["mamba"] = init_mamba(generator, d, cfg.ssm, dtype, device)
    else:
        hd = cfg.head_dim_
        p["wq"] = init_dense(generator, (d, cfg.n_heads * hd), dtype, device)
        p["wk"] = init_dense(generator, (d, cfg.n_kv_heads * hd), dtype,
                             device)
        p["wv"] = init_dense(generator, (d, cfg.n_kv_heads * hd), dtype,
                             device)
        p["wo"] = init_dense(generator, (cfg.n_heads * hd, d), dtype, device)
    if cfg.is_moe(pos):
        p["ln2"] = zeros()
        p["moe"] = moe.init_moe(generator, d, cfg.moe, dtype, device)
    elif cfg.d_ff > 0:
        p["ln2"] = zeros()
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, dtype, device)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """Random weights with the reference's shapes and scales, drawn from
    ``generator`` (which must live on ``device``)."""
    d, v, dtype = cfg.d_model, cfg.padded_vocab, cfg.param_dtype
    params: Dict[str, Any] = {
        # 1/sqrt(d) embeddings: unit-variance hidden state after the
        # gemma-style sqrt(d) embed_scale, and O(1) tied logits at init.
        "embed": init_dense(generator, (v, d), dtype, device,
                            scale=d ** -0.5),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_dense(generator, (d, v), dtype, device)
    if cfg.frontend == "vision":
        params["frontend_proj"] = init_dense(
            generator, (cfg.frontend_dim, d), dtype, device)
    params["periods"] = [
        {str(pos): _init_block(generator, cfg, pos, device)
         for pos in range(cfg.period)}
        for _ in range(cfg.n_periods)]
    return params


def params_shape(cfg: ArchConfig):
    """The parameters laid out on the meta device: every leaf's shape
    and dtype, nothing allocated."""
    return init_params(cfg, None, "meta")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_sub(bp, x: torch.Tensor, cfg: ArchConfig, pos: int,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Attention sub-block.  ``cache``: this layer's {"k", "v"} buffers,
    (B, Hkv, S_max, hd), written in place (with ``k_scale`` and
    ``v_scale``, (B, Hkv, S_max, 1), for the int8 cache); None attends
    without one.

    With more than one token (prefill) it attends over the fresh k/v
    and writes them at offset 0 (single-shot prefill starts the
    sequence, as in the reference); with one token (decode) it writes
    position ``q_offset`` and attends over the whole buffer, masked by
    that position (dequantized first where the cache is int8).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    window = cfg.sliding_window if cfg.kind(pos) == "attn_local" else None

    h = rms_norm(x, bp["ln1"], cfg.rms_eps)
    q = (h @ bp["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ bp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ bp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    positions = q_offset + torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if cache is None or s > 1:
        o = attention(qt, kt, vt, causal=True, window=window, q_offset=0)
        if cache is not None:
            _write_rows(cache, kt, vt, slice(0, s))
    else:
        _write_rows(cache, kt, vt, slice(q_offset, q_offset + 1))
        k_all, v_all = cache["k"], cache["v"]
        if "k_scale" in cache:
            k_all = (k_all.float() * cache["k_scale"]).to(x.dtype)
            v_all = (v_all.float() * cache["v_scale"]).to(x.dtype)
        o = attention(qt, k_all, v_all, causal=True, window=window,
                      q_offset=q_offset)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return o @ bp["wo"]


def _write_rows(cache: Dict[str, torch.Tensor], kt: torch.Tensor,
                vt: torch.Tensor, rows: slice) -> None:
    """Write (B, Hkv, s, hd) k/v at positions ``rows`` of the cache, as
    int8 rows and their scales where the cache is quantized."""
    for name, t in (("k", kt), ("v", vt)):
        if name + "_scale" in cache:
            q8, scale = _quant_rows(t)
            cache[name][:, :, rows] = q8
            cache[name + "_scale"][:, :, rows] = scale
        else:
            cache[name][:, :, rows] = t


_RECIP_127 = float(np.float32(1) / np.float32(127))


def _quant_rows(x: torch.Tensor):
    """Per-row int8 quantization over the last dim.  x: (..., hd) ->
    (int8 rows, float32 scales (..., 1)).

    The reference's ``max|x| / 127 + 1e-12`` as its jitted CPU program
    computes it: XLA multiplies by float32(1/127) and fuses the add
    (one rounding, :func:`~repro_torch.numerics.fma_float32`); then
    ``round`` half to even, as ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = fma_float32(amax, torch.full_like(amax, _RECIP_127),
                        torch.full_like(amax, 1e-12))
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q8, scale


def _mamba_sub(bp, x: torch.Tensor, cfg: ArchConfig,
               cache: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """A mamba layer's mixer.  ``cache``: its {"conv", "ssm"} state,
    replaced by the state after ``x``; prefill passes the zeroed state
    in, as the reference does."""
    h = rms_norm(x, bp["ln1"], cfg.rms_eps)
    state = None if cache is None else MambaState(cache["conv"],
                                                  cache["ssm"])
    y, new = mamba_block(bp["mamba"], h, cfg.ssm, state=state)
    if cache is not None:
        cache["conv"] = new.conv.to(cache["conv"].dtype)
        cache["ssm"] = new.ssm
    return y


def _ffn_sub(bp, x: torch.Tensor, cfg: ArchConfig,
             pos: int) -> Optional[torch.Tensor]:
    if cfg.is_moe(pos):
        h = rms_norm(x, bp["ln2"], cfg.rms_eps)
        y, _stats = moe.moe_layer(bp["moe"], h, cfg.moe, act=cfg.act)
        return y
    if cfg.d_ff > 0:
        h = rms_norm(x, bp["ln2"], cfg.rms_eps)
        return gated_mlp(h, bp["mlp"]["w_gate"], bp["mlp"]["w_up"],
                         bp["mlp"]["w_down"], act=cfg.act)
    return None


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _apply_period_train(period_params, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    for pos in range(cfg.period):
        bp = period_params[str(pos)]
        if cfg.kind(pos) == "mamba":
            x = x + _mamba_sub(bp, x, cfg)
        else:
            x = x + _attn_sub(bp, x, cfg, pos)
        f = _ffn_sub(bp, x, cfg, pos)
        if f is not None:
            x = x + f
    return x


# the matmuls without batch dimensions: what JAX's
# dots_with_no_batch_dims_saveable keeps (batched products recompute)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None,
            remat: str = "full") -> torch.Tensor:
    """Token ids (B, S) (+ the vision front end's ``embeds``) -> the
    final hidden states (B, n_front + S, d)."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}; one of {REMAT}")
    x = _embed_in(params, cfg, tokens, embeds)
    body = functools.partial(_apply_period_train, cfg=cfg)
    grad = torch.is_grad_enabled()
    for period_params in params["periods"]:
        if remat == "none" or not grad:
            x = body(period_params, x)
        elif remat == "full":
            x = checkpoint(body, period_params, x, use_reentrant=False)
        else:
            x = checkpoint(body, period_params, x, use_reentrant=False,
                           context_fn=functools.partial(
                               create_selective_checkpoint_contexts,
                               _save_dots))
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def train_loss(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               remat: str = "full", loss_chunk: int = 512) -> torch.Tensor:
    """The token-mean next-token loss of ``batch`` ({"tokens", "labels"}
    (B, S) int, -1 labels ignored, and "embeds" with a vision front
    end), a float32 scalar."""
    embeds = batch.get("embeds")
    x = forward(params, cfg, batch["tokens"], embeds, remat=remat)
    w_un = (params["embed"].T if cfg.tie_embeddings
            else params["unembed"]).to(cfg.compute_dtype)
    labels = batch["labels"]
    if cfg.frontend == "vision" and embeds is not None:
        # the front end's positions carry no next-token loss
        pad = torch.full((labels.shape[0], embeds.shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return chunked_cross_entropy(x, w_un, labels, chunk=loss_chunk,
                                 vocab_size=cfg.vocab_size)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """The serving state, and the next position, ``pos``: zeroed k/v
    buffers (B, Hkv, max_seq, hd) for every attention layer (int8 with
    float32 (B, Hkv, max_seq, 1) scales under ``kv_quant``), and a
    zeroed conv state (B, W-1, conv_dim) and float32 SSM state (B, H, P,
    N) for every mamba layer."""
    dtype = dtype or cfg.compute_dtype

    def layer(pos: int) -> Dict[str, torch.Tensor]:
        if cfg.kind(pos) == "mamba":
            st = init_mamba_state(batch, cfg.d_model, cfg.ssm, dtype, device)
            return {"conv": st.conv, "ssm": st.ssm}
        shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim_)
        if cfg.kv_quant:
            # int8 rows + f32 per-(b, h, s) scales: half the residency
            scales = shape[:-1] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(scales, dtype=torch.float32,
                                           device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v_scale": torch.zeros(scales, dtype=torch.float32,
                                           device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"pos": 0, "periods": [
        {str(pos): layer(pos) for pos in range(cfg.period)}
        for _ in range(cfg.n_periods)]}


def _serve_forward(params, cfg: ArchConfig, x: torch.Tensor,
                   cache: Dict[str, Any]) -> torch.Tensor:
    q_offset = cache["pos"]
    for period_params, cache_period in zip(params["periods"],
                                           cache["periods"]):
        for pos in range(cfg.period):
            bp, cp = period_params[str(pos)], cache_period[str(pos)]
            if cfg.kind(pos) == "mamba":
                x = x + _mamba_sub(bp, x, cfg, cp)
            else:
                x = x + _attn_sub(bp, x, cfg, pos, cp, q_offset)
            f = _ffn_sub(bp, x, cfg, pos)
            if f is not None:
                x = x + f
    cache["pos"] = q_offset + x.shape[1]
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def _embed_in(params, cfg: ArchConfig, tokens: torch.Tensor,
              embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                             device=x.device)
    if cfg.frontend == "vision" and embeds is not None:
        fe = embeds.to(cfg.compute_dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x], dim=1)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    w_un = (params["embed"].T if cfg.tie_embeddings
            else params["unembed"]).to(cfg.compute_dtype)
    return x[:, -1] @ w_un


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict[str, Any], embeds: Optional[torch.Tensor] = None):
    """Run the prompt (B, S) through the model, filling the cache; with
    a vision front end, ``embeds`` (B, n_front, frontend_dim) go first.

    Returns (last-position logits (B, V_padded), cache)."""
    x = _serve_forward(params, cfg, _embed_in(params, cfg, tokens, embeds),
                       cache)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any]):
    """One autoregressive step.  token: (B, 1) -> (logits (B, V_padded),
    cache)."""
    x = _serve_forward(params, cfg, _embed_in(params, cfg, token), cache)
    return _logits(params, cfg, x), cache
