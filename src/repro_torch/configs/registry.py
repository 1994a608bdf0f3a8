"""Architecture registry + reduced smoke configs for CPU tests.

The port's copy of ``src/repro/configs/registry.py``, all ten of its
configurations: gemma3-12b (GQA, a 5:1 local:global window pattern,
head_dim 256), gemma-2b (MQA, GeGLU), llama3-405b and
mistral-large-123b (SwiGLU, plain GQA), musicgen-medium (full MHA over
audio codes; its audio front end is the reference's stub, so it is a
dense decoder), the two MoE decoders granite-moe-3b-a800m (40 experts,
top-8) and dbrx-132b (16 experts, top-4), pixtral-12b (a vision front
end's patch embeddings prepended to the tokens), mamba2-130m (Mamba-2
SSD layers only) and jamba-1.5-large-398b (one attention layer to
seven Mamba-2 ones, MoE every second layer).  :func:`smoke_config` is
the reference's, field for field, with torch dtypes, so a smoke config
here and there has the same shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .base import ArchConfig
from . import (dbrx_132b, gemma3_12b, gemma_2b, granite_moe_3b_a800m,
               jamba_1_5_large_398b, llama3_405b, mamba2_130m,
               mistral_large_123b, musicgen_medium, pixtral_12b)

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        gemma3_12b, gemma_2b, llama3_405b, mistral_large_123b,
        jamba_1_5_large_398b, pixtral_12b, granite_moe_3b_a800m,
        dbrx_132b, musicgen_medium, mamba2_130m)
}

__all__ = ["ARCHS", "get_arch", "smoke_config"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Same family/pattern, tiny dimensions.

    Preserves: period structure, layer kinds, MoE/SSM presence, frontend,
    activation, GQA ratio (when it divides), tying.  Shrinks everything
    else.
    """
    heads = 4 if cfg.n_heads else 0
    kv = 0
    if cfg.n_kv_heads:
        kv = max(1, heads * cfg.n_kv_heads // max(cfg.n_heads, 1))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64, extra_slots=4)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                  chunk=32)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=cfg.period * 2,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        moe=moe,
        ssm=ssm,
        n_frontend_tokens=8 if cfg.frontend == "vision" else 0,
        frontend_dim=32,
        sliding_window=16 if cfg.sliding_window else None,
        max_seq_len=256,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
