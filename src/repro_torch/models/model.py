"""Decoder LM, the serving path: init / cache / prefill / decode.

Counterpart of ``src/repro/models/model.py`` (``init_params``,
``init_cache``, ``prefill``, ``decode_step``, ``_attn_sub``,
``_ffn_sub``) for the dense and the MoE configurations.  A MoE layer
(``cfg.is_moe(pos)``) holds ``ln2`` and ``moe`` in place of ``mlp`` and
runs ``models/moe.py:moe_layer`` in its config's dense dispatch mode,
one dispatch group (the reference's group count without a mesh).
What differs:

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
  The cache is bfloat16 (the compute dtype); ``kv_quant`` is not ported.
* Prefill attends through the flash-attention kernel
  (``models/attention.py``); decode through the dense rows.

A configuration with SSM (mamba) layers, a vision front end, or an
int8 KV cache raises ``NotImplementedError`` naming the ROADMAP item
that brings it (A12).  The audio front end (musicgen-medium) is
a stub in the reference, whose model branches only on ``"vision"``: it
consumes audio codes as tokens, and so does the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig
from . import moe
from .attention import attention
from .layers import gated_mlp, init_dense, init_mlp, rms_norm, rope

__all__ = ["check_served", "init_params", "init_cache", "prefill",
           "decode_step"]


def check_served(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a decoder the port serves: dense or MoE
    layers over tokens (the audio stub's codes count as tokens)."""
    if cfg.ssm is not None or any(cfg.kind(p) == "mamba"
                                  for p in range(cfg.period)):
        raise NotImplementedError(f"{cfg.name}: SSM (mamba) layers are not "
                                  f"ported yet (ROADMAP A12)")
    if cfg.frontend not in (None, "audio"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} front "
                                  f"end is not ported yet (ROADMAP A12)")
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: the int8 KV cache "
                                  f"(kv_quant) is not ported yet (ROADMAP "
                                  f"A12)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(generator: torch.Generator, cfg: ArchConfig, pos: int,
                device):
    d, dtype, hd = cfg.d_model, cfg.param_dtype, cfg.head_dim_
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)  # noqa: E731
    p: Dict[str, Any] = {"ln1": zeros()}
    p["wq"] = init_dense(generator, (d, cfg.n_heads * hd), dtype, device)
    p["wk"] = init_dense(generator, (d, cfg.n_kv_heads * hd), dtype, device)
    p["wv"] = init_dense(generator, (d, cfg.n_kv_heads * hd), dtype, device)
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
    check_served(cfg)
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
    params["periods"] = [
        {str(pos): _init_block(generator, cfg, pos, device)
         for pos in range(cfg.period)}
        for _ in range(cfg.n_periods)]
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_sub(bp, x: torch.Tensor, cfg: ArchConfig, pos: int,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Attention sub-block.  ``cache``: this layer's {"k", "v"} buffers,
    (B, Hkv, S_max, hd), written in place; None attends without one.

    With more than one token (prefill) it attends over the fresh k/v
    and writes them at offset 0 (single-shot prefill starts the
    sequence, as in the reference); with one token (decode) it writes
    position ``q_offset`` and attends over the whole buffer, masked by
    that position.
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
            cache["k"][:, :, :s] = kt
            cache["v"][:, :, :s] = vt
    else:
        cache["k"][:, :, q_offset:q_offset + 1] = kt
        cache["v"][:, :, q_offset:q_offset + 1] = vt
        o = attention(qt, cache["k"], cache["v"], causal=True, window=window,
                      q_offset=q_offset)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return o @ bp["wo"]


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
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """Zeroed k/v buffers (B, Hkv, max_seq, hd) for every attention
    layer, and the next position, ``pos``."""
    check_served(cfg)
    dtype = dtype or cfg.compute_dtype
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim_)
    return {"pos": 0, "periods": [
        {str(pos): {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
         for pos in range(cfg.period)}
        for _ in range(cfg.n_periods)]}


def _serve_forward(params, cfg: ArchConfig, x: torch.Tensor,
                   cache: Dict[str, Any]) -> torch.Tensor:
    q_offset = cache["pos"]
    for period_params, cache_period in zip(params["periods"],
                                           cache["periods"]):
        for pos in range(cfg.period):
            bp = period_params[str(pos)]
            x = x + _attn_sub(bp, x, cfg, pos, cache_period[str(pos)],
                              q_offset)
            f = _ffn_sub(bp, x, cfg, pos)
            if f is not None:
                x = x + f
    cache["pos"] = q_offset + x.shape[1]
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def _embed_in(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                             device=x.device)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    w_un = (params["embed"].T if cfg.tie_embeddings
            else params["unembed"]).to(cfg.compute_dtype)
    return x[:, -1] @ w_un


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict[str, Any]):
    """Run the prompt (B, S) through the model, filling the cache.

    Returns (last-position logits (B, V_padded), cache)."""
    check_served(cfg)
    x = _serve_forward(params, cfg, _embed_in(params, cfg, tokens), cache)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any]):
    """One autoregressive step.  token: (B, 1) -> (logits (B, V_padded),
    cache)."""
    check_served(cfg)
    x = _serve_forward(params, cfg, _embed_in(params, cfg, token), cache)
    return _logits(params, cfg, x), cache
