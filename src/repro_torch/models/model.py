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

from ..device import resolve_device
from ..configs.base import ArchConfig
from ..numerics import fma_float32
from ..sharding.parallel import (Par, all_reduce_, gather_from, gather_to,
                                 local, seq_chunks, split_to)
from . import moe
from .attention import attention
from .layers import (cross_entropy_sums, gated_mlp, init_dense, init_mlp,
                     rms_norm, rope)
from .ssm import (MambaState, init_mamba, init_mamba_state, mamba_block,
                  mamba_block_tp)

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
              q_offset: int = 0, par: Optional[Par] = None,
              sp: bool = False, seqc=None) -> torch.Tensor:
    """Attention sub-block.  ``cache``: this layer's {"k", "v"} buffers,
    (B, Hkv, S_max, hd), written in place (with ``k_scale`` and
    ``v_scale``, (B, Hkv, S_max, 1), for the int8 cache); None attends
    without one.

    With more than one token (prefill) it attends over the fresh k/v
    and writes them at offset 0 (single-shot prefill starts the
    sequence, as in the reference); with one token (decode) it writes
    position ``q_offset`` and attends over the whole buffer, masked by
    that position (dequantized first where the cache is int8).

    On a mesh (``par``) with a 'model' axis, or a cache whose sequence
    the mesh splits (``seqc``, ``sharding.parallel.seq_chunks``), the
    block runs :func:`_attn_tp` on local shards.
    """
    if par is not None and (par.on or (seqc is not None and seqc[2])):
        return _attn_tp(bp, x, cfg, pos, cache, q_offset, par, sp, seqc)
    w = local if par is None else par.w
    b, s, _ = x.shape
    hd = cfg.head_dim_
    window = cfg.sliding_window if cfg.kind(pos) == "attn_local" else None

    h = rms_norm(x, w(bp["ln1"]), cfg.rms_eps)
    q = (h @ w(bp["wq"])).reshape(b, s, cfg.n_heads, hd)
    k = (h @ w(bp["wk"])).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ w(bp["wv"])).reshape(b, s, cfg.n_kv_heads, hd)
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
    return o @ w(bp["wo"])


def _kv_of_heads(k: torch.Tensor, v: torch.Tensor, first: int, n: int,
                 g: int):
    """The (B, S, ., hd) keys and values that q heads [first, first + n)
    read (q head j reads kv head j // g), laid out so that the
    attention's own grouping (n // kv heads q heads a kv head) pairs
    them right."""
    if n % g == 0:
        sl = slice(first // g, (first + n) // g)
    elif g % n == 0:
        sl = slice(first // g, first // g + 1)
    else:
        idx = torch.arange(first, first + n, device=k.device) // g
        return k[:, :, idx], v[:, :, idx]
    return k[:, :, sl], v[:, :, sl]


def _attn_tp(bp, x: torch.Tensor, cfg: ArchConfig, pos: int, cache,
             q_offset: int, par: Par, sp: bool, seqc) -> torch.Tensor:
    """The attention sub-block on this rank's shards.

    ``wq`` / ``wk`` / ``wv`` are column shards and ``wo`` a row shard
    over 'model' (the rules' specs).  Training and prefill take the
    layout ``rules.heads`` chose for q:

    * heads over 'model' (H divides): this rank's H/m query heads, its
      own k/v heads where Hkv divides too, else k/v gathered whole and
      the heads its queries read picked; ``wo`` row-parallel, then the
      partial sums reduced;
    * the sequence over 'model' (H does not divide, S does): the
      weights gathered whole, k/v computed whole on every rank, and this
      rank's S/m queries attend to the key prefix that ends at its last
      query (so the kernel's right-aligned causal mask is the global
      one); the rows' outputs gathered along the sequence;
    * neither: every rank computes the whole block.

    Decode (one token against the cache) computes q / k / v for every
    head (column products gathered), writes the new row into the rank
    that holds its position, attends over this rank's chunk of the
    cache's sequence and combines the chunks' softmax terms over the
    axes that split it (max, then sums), and runs ``wo`` row-parallel.
    """
    b = x.shape[0]
    hd, nh, nkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    window = cfg.sliding_window if cfg.kind(pos) == "attn_local" else None
    grp, m = par.group, par.m
    h = rms_norm(x, par.norm_w(bp["ln1"], sp), cfg.rms_eps)
    wq, wk, wv, wo = (par.w(bp[n]) for n in ("wq", "wk", "wv", "wo"))
    seq = h.shape[1] * (m if sp else 1)
    theta = cfg.rope_theta

    if cache is not None and seq == 1:
        pos_t = q_offset + torch.arange(1, device=x.device)
        q = rope(gather_from(h @ wq, -1, grp).reshape(b, 1, nh, hd), pos_t,
                 theta)
        k = rope(gather_from(h @ wk, -1, grp).reshape(b, 1, nkv, hd), pos_t,
                 theta)
        v = gather_from(h @ wv, -1, grp).reshape(b, 1, nkv, hd)
        _write_chunk(cache, k.transpose(1, 2), v.transpose(1, 2), q_offset,
                     seqc)
        o = _decode_rows(q.transpose(1, 2), cache, q_offset, window, seqc,
                         x.dtype)
        o = o.transpose(1, 2).reshape(b, 1, nh * hd)
        return par.leave(o[..., par.cols(nh * hd)] @ wo, False)

    positions = q_offset + torch.arange(seq, device=x.device)
    kv = None
    if nh % m == 0:
        hc = par.enter(h, sp)
        nq = nh // m
        q = rope((hc @ wq).reshape(b, seq, nq, hd), positions, theta)
        if nkv % m == 0 and cache is None:
            kq = rope((hc @ wk).reshape(b, seq, nkv // m, hd), positions,
                      theta)
            vq = (hc @ wv).reshape(b, seq, nkv // m, hd)
        else:
            kv = (rope(gather_to(hc @ wk, -1, grp).reshape(b, seq, nkv, hd),
                       positions, theta),
                  gather_to(hc @ wv, -1, grp).reshape(b, seq, nkv, hd))
            kq, vq = _kv_of_heads(*kv, par.rank * nq, nq, nh // nkv)
        o = attention(q.transpose(1, 2), kq.transpose(1, 2),
                      vq.transpose(1, 2), causal=True, window=window,
                      q_offset=0)
        out = par.leave(o.transpose(1, 2).reshape(b, seq, nq * hd) @ wo, sp)
    elif seq % m == 0:
        hc = par.enter(h, sp)
        w_q, w_k, w_v = (gather_to(w_, 1, grp) for w_ in (wq, wk, wv))
        w_o = gather_to(wo, 0, grp)
        kv = (rope((hc @ w_k).reshape(b, seq, nkv, hd), positions, theta),
              (hc @ w_v).reshape(b, seq, nkv, hd))
        rows = par.cols(seq)
        q = rope((hc[:, rows] @ w_q).reshape(b, seq // m, nh, hd),
                 positions[rows], theta)
        o = attention(q.transpose(1, 2), kv[0][:, :rows.stop].transpose(1, 2),
                      kv[1][:, :rows.stop].transpose(1, 2), causal=True,
                      window=window)
        out = o.transpose(1, 2).reshape(b, seq // m, nh * hd) @ w_o
        if not sp:
            out = gather_from(out, 1, grp)
    else:
        w_q, w_k, w_v = (gather_from(w_, 1, grp) for w_ in (wq, wk, wv))
        w_o = gather_from(wo, 0, grp)
        q = rope((h @ w_q).reshape(b, seq, nh, hd), positions, theta)
        kv = (rope((h @ w_k).reshape(b, seq, nkv, hd), positions, theta),
              (h @ w_v).reshape(b, seq, nkv, hd))
        o = attention(q.transpose(1, 2), kv[0].transpose(1, 2),
                      kv[1].transpose(1, 2), causal=True, window=window,
                      q_offset=0)
        out = o.transpose(1, 2).reshape(b, seq, nh * hd) @ w_o
    if cache is not None:
        _write_chunk(cache, kv[0].transpose(1, 2), kv[1].transpose(1, 2), 0,
                     seqc)
    return out


def _write_chunk(cache, kt: torch.Tensor, vt: torch.Tensor, start: int,
                 seqc) -> None:
    """Write (B, Hkv, n, hd) k/v at global positions [start, start + n)
    into the part of them this rank's cache chunk holds."""
    c_lo, c_len = seqc[0], seqc[1]
    n = kt.shape[2]
    lo, hi = max(start, c_lo), min(start + n, c_lo + c_len)
    if lo < hi:
        _write_rows(cache, kt[:, :, lo - start:hi - start],
                    vt[:, :, lo - start:hi - start],
                    slice(lo - c_lo, hi - c_lo))


def _decode_rows(q: torch.Tensor, cache, q_offset: int,
                 window: Optional[int], seqc, dtype) -> torch.Tensor:
    """Dense-row attention of q (B, H, 1, hd) over this rank's chunk of
    the cache, masked by the position, the chunks combined over the axes
    that split the sequence: the maximum, then the exponentials' sums
    and their weighted values, in float32."""
    k_all, v_all = cache["k"], cache["v"]
    if "k_scale" in cache:
        k_all = (k_all.float() * cache["k_scale"]).to(dtype)
        v_all = (v_all.float() * cache["v_scale"]).to(dtype)
    c_lo, c_len, groups = seqc
    b, hq, sq, d = q.shape
    hkv = k_all.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k_all).float() * d ** -0.5
    kpos = c_lo + torch.arange(c_len, device=q.device)
    mask = kpos <= q_offset
    if window is not None:
        mask &= kpos > q_offset - window
    s = torch.where(mask, s, -1e30)
    mx = s.amax(dim=-1, keepdim=True)
    for g in groups:
        all_reduce_(mx, g, torch.distributed.ReduceOp.MAX)
    p = torch.where(mask, torch.exp(s - mx), 0.0)
    tot = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v_all.float())
    for g in groups:
        all_reduce_(tot, g)
        all_reduce_(o, g)
    return (o / tot).to(q.dtype).reshape(b, hq, sq, d)


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
               cache: Optional[Dict[str, torch.Tensor]] = None,
               par: Optional[Par] = None, sp: bool = False) -> torch.Tensor:
    """A mamba layer's mixer.  ``cache``: its {"conv", "ssm"} state,
    overwritten in place by the state after ``x``; prefill passes the
    zeroed state in, as the reference does.

    With 'model' ranks (``par.on``) the mixer runs its heads split over
    them (``ssm.mamba_block_tp``); the cache's SSM heads are this rank's
    already, its conv channels (contiguous shards over 'model') are
    gathered whole and re-split around the call."""
    if par is not None and par.on:
        return _mamba_tp(bp, x, cfg, cache, par, sp)
    w = local if par is None else par.w
    h = rms_norm(x, w(bp["ln1"]), cfg.rms_eps)
    state = None if cache is None else MambaState(cache["conv"],
                                                  cache["ssm"])
    mixer = bp["mamba"] if par is None else {
        k: par.w(v) for k, v in bp["mamba"].items()}
    y, new = mamba_block(mixer, h, cfg.ssm, state=state)
    if cache is not None:
        cache["conv"].copy_(new.conv)
        cache["ssm"].copy_(new.ssm)
    return y


def _mamba_tp(bp, x, cfg: ArchConfig, cache, par: Par, sp: bool):
    s = cfg.ssm
    d = x.shape[-1]
    di, ns, hp = s.d_inner(d), s.d_state, s.head_dim
    hl = s.n_heads(d) // par.m
    h = rms_norm(x, par.norm_w(bp["ln1"], sp), cfg.rms_eps)
    state = None
    if cache is not None:
        conv = gather_from(cache["conv"], -1, par.group)       # all channels
        mine = torch.cat([
            torch.arange(par.rank * hl * hp, (par.rank + 1) * hl * hp,
                         device=x.device),
            torch.arange(di, di + 2 * ns, device=x.device)])
        state = MambaState(conv[..., mine], cache["ssm"])
    y, new = mamba_block_tp(bp["mamba"], par.enter(h, sp), s, par, state)
    if cache is not None:
        xs = gather_from(new.conv[..., :hl * hp].contiguous(), -1, par.group)
        whole = torch.cat([xs, new.conv[..., hl * hp:]], dim=-1)
        cache["conv"].copy_(whole[..., par.cols(whole.shape[-1])])
        cache["ssm"].copy_(new.ssm)
    return par.leave(y, sp)


def _ffn_sub(bp, x: torch.Tensor, cfg: ArchConfig, pos: int,
             par: Optional[Par] = None, sp: bool = False,
             moe_kw: Optional[dict] = None) -> Optional[torch.Tensor]:
    """The MLP or MoE sub-block.  With 'model' ranks the MLP is
    column-parallel ``w_gate`` / ``w_up``, row-parallel ``w_down`` and
    the partial sums reduced; the MoE layer runs its experts as the
    rules split them (``moe.moe_layer(par=...)``), its dispatch groups
    those of ``moe_kw`` (the reference's ``rules.moe_groups()``)."""
    w = local if par is None else par.w
    tp = par is not None and par.on
    ln2 = None
    if "ln2" in bp:
        ln2 = w(bp["ln2"]) if not sp else par.norm_w(bp["ln2"], sp)
    if cfg.is_moe(pos):
        h = rms_norm(x, ln2, cfg.rms_eps)
        if tp:
            h = par.enter(h, sp)
        y, _stats = moe.moe_layer(bp["moe"], h, cfg.moe, act=cfg.act,
                                  par=par, **(moe_kw or {}))
        return par.leave(y, sp) if tp else y
    if cfg.d_ff > 0:
        h = rms_norm(x, ln2, cfg.rms_eps)
        if tp:
            h = par.enter(h, sp)
        mlp = bp["mlp"]
        y = gated_mlp(h, w(mlp["w_gate"]), w(mlp["w_up"]), w(mlp["w_down"]),
                      act=cfg.act)
        return par.leave(y, sp) if tp else y
    return None


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _apply_period_train(period_params, x: torch.Tensor, cfg: ArchConfig,
                        par: Optional[Par] = None, sp: bool = False,
                        moe_kw: Optional[dict] = None) -> torch.Tensor:
    for pos in range(cfg.period):
        bp = period_params[str(pos)]
        if cfg.kind(pos) == "mamba":
            x = x + _mamba_sub(bp, x, cfg, par=par, sp=sp)
        else:
            x = x + _attn_sub(bp, x, cfg, pos, par=par, sp=sp)
        f = _ffn_sub(bp, x, cfg, pos, par, sp, moe_kw)
        if f is not None:
            x = x + f
    return x


def _mesh_inputs(rules, *inputs):
    """(Par, the inputs' local rows, the global batch) of a call: the
    inputs are DTensors laid out by ``rules.batch_spec`` (the step
    builders distribute them), or whole tensors, every rank's the same,
    of which each rank keeps its rows; no rules: as they are."""
    par = Par(rules)
    first = inputs[0]
    if par.mesh is None:
        return (par, *inputs, first.shape[0])
    from torch.distributed.tensor import DTensor

    from ..sharding.parallel import distribute

    out = []
    for t in inputs:
        if t is not None and not isinstance(t, DTensor):
            t = distribute(t, rules.batch_spec(t.shape[0])
                           + (None,) * (t.dim() - 2), par.mesh)
        out.append(None if t is None else t.to_local())
    return (par, *out, first.shape[0])


def _moe_groups(rules, par: Par, batch: int) -> dict:
    """The MoE layer's dispatch groups on a mesh: the reference's
    ``rules.moe_groups()`` in all, this rank's share of them (the batch
    axes that split the hidden rows split the groups), and the groups
    of those axes, over which the routing histogram is summed."""
    if par.mesh is None:
        return {}
    from ..sharding.specs import axis_sizes
    total = rules.moe_groups()
    entry = rules.hidden_spec((batch, 1, 1))[0]
    axes = () if entry is None else (
        tuple(entry) if isinstance(entry, tuple) else (entry,))
    sizes = axis_sizes(par.mesh)
    shards = 1
    for a in axes:
        shards *= sizes[a]
    return {"groups": max(1, total // shards), "total_groups": total,
            "count_groups": [par.mesh.get_group(a) for a in axes
                             if sizes[a] > 1]}


# the matmuls without batch dimensions: what JAX's
# dots_with_no_batch_dims_saveable keeps (batched products recompute)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None,
            remat: str = "full", *, rules=None) -> torch.Tensor:
    """Token ids (B, S) (+ the vision front end's ``embeds``) -> the
    final hidden states (B, n_front + S, d).

    ``rules`` (``sharding.make_rules``): with a mesh, the parameters are
    DTensors laid out by its specs, the inputs DTensors laid out by
    ``rules.batch_spec`` (or whole tensors, the same on every rank),
    and the result is this rank's rows (its sequence shard too where
    the rules are sequence-parallel)."""
    par, tokens, embeds, batch = _mesh_inputs(rules, tokens, embeds)
    return _forward(params, cfg, tokens, embeds, remat, par, batch)[0]


def _forward(params, cfg: ArchConfig, tokens, embeds, remat: str, par: Par,
             batch: int):
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}; one of {REMAT}")
    seq = tokens.shape[1] + (embeds.shape[1] if cfg.frontend == "vision"
                             and embeds is not None else 0)
    sp = par.sp(seq)
    x = _embed_in(params, cfg, tokens, embeds, par, sp)
    body = functools.partial(_apply_period_train, cfg=cfg, par=par, sp=sp,
                             moe_kw=_moe_groups(par.rules, par, batch))
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
    return rms_norm(x, par.norm_w(params["final_norm"], sp), cfg.rms_eps), sp


def train_loss(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               remat: str = "full", loss_chunk: int = 512, *,
               rules=None) -> torch.Tensor:
    """The token-mean next-token loss of ``batch`` ({"tokens", "labels"}
    (B, S) int, -1 labels ignored, and "embeds" with a vision front
    end), a float32 scalar.

    With a mesh (``rules``) it is this rank's share: its rows' summed
    loss over the labelled count of the whole batch (summed over the
    batch axes), so the shares, and their gradients, sum over the batch
    axes to the loss and its gradient; the vocabulary is split over
    'model' as ``unembed`` (or the tied embedding) is, and the
    log-sum-exp reduced over its ranks."""
    par, tokens, labels, embeds, b = _mesh_inputs(
        rules, batch["tokens"], batch["labels"], batch.get("embeds"))
    x, sp = _forward(params, cfg, tokens, embeds, remat, par, b)
    w_un = (par.w(params["embed"]).T if cfg.tie_embeddings
            else par.w(params["unembed"])).to(cfg.compute_dtype)
    if cfg.frontend == "vision" and embeds is not None:
        # the front end's positions carry no next-token loss
        pad = torch.full((labels.shape[0], embeds.shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    if par.on:
        x = par.enter(x, sp)
    total, count = cross_entropy_sums(x, w_un, labels, chunk=loss_chunk,
                                      vocab_size=cfg.vocab_size, par=par)
    if par.mesh is not None:
        count = par.batch_sum_(count.detach().clone())
    return total / torch.clamp_min(count, 1.0)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """The serving state, and the next position, ``pos``: zeroed k/v
    buffers (B, Hkv, max_seq, hd) for every attention layer (int8 with
    float32 (B, Hkv, max_seq, 1) scales under ``kv_quant``), and a
    zeroed conv state (B, W-1, conv_dim) and float32 SSM state (B, H, P,
    N) for every mamba layer.  ``device`` None is the card
    (``device.resolve_device``); "meta" lays out shapes only."""
    dtype = dtype or cfg.compute_dtype
    device = resolve_device(device)

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
                   cache: Dict[str, Any], par: Optional[Par] = None,
                   sp: bool = False, moe_kw: Optional[dict] = None
                   ) -> torch.Tensor:
    q_offset = cache["pos"]
    seq = x.shape[1] * (par.m if sp else 1)
    seqc = None
    for period_params, cache_period in zip(params["periods"],
                                           cache["periods"]):
        for pos in range(cfg.period):
            bp = period_params[str(pos)]
            cp = {k: local(v) for k, v in cache_period[str(pos)].items()}
            if cfg.kind(pos) == "mamba":
                x = x + _mamba_sub(bp, x, cfg, cp, par, sp)
            else:
                if seqc is None and par is not None:
                    seqc = seq_chunks(cache_period[str(pos)]["k"])
                x = x + _attn_sub(bp, x, cfg, pos, cp, q_offset, par, sp,
                                  seqc)
            f = _ffn_sub(bp, x, cfg, pos, par, sp, moe_kw)
            if f is not None:
                x = x + f
    cache["pos"] = q_offset + seq
    w = local if par is None else par.w
    x = rms_norm(x, w(params["final_norm"]), cfg.rms_eps)
    if sp:
        x = gather_from(x, 1, par.group)
    return x


def _embed_in(params, cfg: ArchConfig, tokens: torch.Tensor,
              embeds: Optional[torch.Tensor] = None,
              par: Optional[Par] = None, sp: bool = False) -> torch.Tensor:
    """Token rows (and the vision front end's) as the residual stream.
    With 'model' ranks the embedding's vocabulary rows are split over
    them: each rank looks up the tokens it holds, zeros elsewhere, and
    the rows are summed over the ranks (exact: one term is not zero);
    sequence-parallel, each rank then keeps its slice."""
    w = local if par is None else par.w
    table = w(params["embed"])
    if par is not None and par.on:
        vl = table.shape[0]
        rel = tokens.long() - par.rank * vl
        mine = (rel >= 0) & (rel < vl)
        x = torch.where(mine[..., None], table[rel.clamp(0, vl - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        x = par.leave(x, False)
    else:
        x = table[tokens.long()]
    x = x.to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                             device=x.device)
    if cfg.frontend == "vision" and embeds is not None:
        fe = embeds.to(cfg.compute_dtype) @ w(params["frontend_proj"])
        if par is not None and par.on:
            fe = gather_from(fe, -1, par.group)
        x = torch.cat([fe, x], dim=1)
    if sp:
        x = split_to(x, 1, par.group)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            par: Optional[Par] = None) -> torch.Tensor:
    w = local if par is None else par.w
    w_un = (w(params["embed"]).T if cfg.tie_embeddings
            else w(params["unembed"])).to(cfg.compute_dtype)
    logits = x[:, -1] @ w_un
    if par is not None and par.on:
        logits = gather_from(logits, -1, par.group)
    return logits


def _mesh_out(logits: torch.Tensor, par: Par, b: int):
    """The logits (this rank's rows of a batch of ``b``) as a DTensor of
    the batch's layout on a mesh."""
    if par.mesh is None:
        return logits
    from torch.distributed.tensor import DTensor

    from ..sharding.specs import placements
    return DTensor.from_local(logits, par.mesh, placements(
        par.rules.batch_spec(b), par.mesh), run_check=False,
        shape=(b,) + tuple(logits.shape[1:]),
        stride=(logits.shape[1], 1))


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict[str, Any], embeds: Optional[torch.Tensor] = None, *,
            rules=None):
    """Run the prompt (B, S) through the model, filling the cache; with
    a vision front end, ``embeds`` (B, n_front, frontend_dim) go first.

    Returns (last-position logits (B, V_padded), cache).  With a mesh
    (``rules``) the parameters and the cache are DTensors laid out by
    the rules' specs, and the logits a DTensor of the batch's layout."""
    par, tokens, embeds, batch = _mesh_inputs(rules, tokens, embeds)
    seq = tokens.shape[1] + (embeds.shape[1] if cfg.frontend == "vision"
                             and embeds is not None else 0)
    sp = par.sp(seq)
    x = _serve_forward(params, cfg,
                       _embed_in(params, cfg, tokens, embeds, par, sp),
                       cache, par, sp, _moe_groups(rules, par, batch))
    return _mesh_out(_logits(params, cfg, x, par), par, batch), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any], *, rules=None):
    """One autoregressive step.  token: (B, 1) -> (logits (B, V_padded),
    cache); ``rules`` as :func:`prefill`'s."""
    par, token, batch = _mesh_inputs(rules, token)
    x = _serve_forward(params, cfg, _embed_in(params, cfg, token, None, par),
                       cache, par, False, _moe_groups(rules, par, batch))
    return _mesh_out(_logits(params, cfg, x, par), par, batch), cache
