"""Architecture configuration schema (one instance per assigned arch).

The port's own copy of ``src/repro/configs/base.py``, field for field,
with torch dtypes in place of the reference's.  The port's model serves
every configuration: ``MoEConfig`` drives ``models/moe.py`` (and
``cluster.moe_dispatch``), ``SSMConfig`` the Mamba-2 mixer of
``models/ssm.py``, ``frontend="vision"`` the projected patch embeddings
and ``kv_quant`` the int8 KV cache (``models/model.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["MoEConfig", "SSMConfig", "ArchConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_n_layers: int = 1          # MoE replaces dense MLP every n layers
    # dispatch: 'capacity'  = standard capacity-factor top-k (baseline,
    #                         the Standard-Repartition-Join analogue)
    #           'alpha_k'   = StatJoin-planned hot-expert replication
    #                         (the paper's technique as MoE dispatch)
    #           'cluster'   = route through the instrumented cluster
    #                         exchange (repro.cluster.moe_dispatch)
    #           'auto'      = planner-scored choice among the above
    dispatch: str = "alpha_k"
    capacity_factor: float = 1.25    # for 'capacity' dispatch
    extra_slots: int = 8             # replicas for hot experts ('alpha_k')
    # Theorem-6 slot capacity multiplier.  None (the default) derives it
    # from CapacityPolicy.moe_dispatch() — the paper's deterministic
    # 2 * T * K / n_slots no-drop bound plus the policy slack; set a
    # float to pin a hand-chosen factor (drops are counted + retryable).
    alpha_k_cap: Optional[float] = None
    replica_choice: str = "round_robin"  # 'round_robin' (StatJoin-style
    #                                       even split) | 'random' (RandJoin)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 96               # chosen so n_heads = expand*d/hd is
    expand: int = 2                  # divisible by the model mesh axis
    conv_width: int = 4
    chunk: int = 256                 # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    act: str = "swiglu"              # swiglu | geglu
    # layer pattern ------------------------------------------------------
    period: int = 1                  # layers per scanned unit
    attn_positions: Optional[Tuple[int, ...]] = None  # in-period attn slots
    #   None => every position is attention (or mamba for ssm family)
    global_attn_positions: Optional[Tuple[int, ...]] = None  # else local
    sliding_window: Optional[int] = None  # for local attention layers
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # frontend stubs -----------------------------------------------------
    frontend: Optional[str] = None   # None | 'vision' | 'audio'
    n_frontend_tokens: int = 0       # precomputed embeddings prepended
    frontend_dim: int = 1024         # raw embedding dim from the stub
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scale
    # misc ---------------------------------------------------------------
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    kv_quant: bool = False           # int8 KV cache (+f32 row scales):
    #                                  halves decode cache residency and
    #                                  read traffic (§Perf, beyond-paper)
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    max_seq_len: int = 131_072
    sub_quadratic: bool = False      # eligible for the long_500k shape
    notes: str = ""

    # ---- derived -------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 so the embedding shards
        evenly on a 16-way tensor axis (granite's 49155 is not even)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers,
                                                  self.period)
        return self.n_layers // self.period

    def kind(self, pos: int) -> str:
        """Layer kind at in-period position pos: attn | attn_local | mamba."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_positions is not None and pos not in self.attn_positions:
            return "mamba"
        if (self.global_attn_positions is not None
                and pos not in self.global_attn_positions):
            return "attn_local"
        return "attn"

    def is_moe(self, pos: int) -> bool:
        return (self.moe is not None
                and pos % self.moe.every_n_layers == self.moe.every_n_layers - 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim_
        total = v * d * (1 if self.tie_embeddings else 2)
        for pos in range(self.period):
            kind = self.kind(pos)
            n = self.n_periods
            if kind in ("attn", "attn_local"):
                qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads)
                o = self.n_heads * hd * d
                total += n * (qkv + o)
            else:  # mamba
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                conv_dim = di + 2 * s.d_state
                total += n * (d * (2 * di + 2 * s.d_state + nh)
                              + conv_dim * s.conv_width + 3 * nh + di
                              + di * d)
            # FFN/MoE follows EVERY layer kind (jamba's mamba layers too)
            if self.is_moe(pos):
                m = self.moe
                total += n * (d * m.num_experts
                              + m.num_experts * 3 * d * m.d_ff_expert)
            elif ff:
                total += n * 3 * d * ff
            total += n * 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_moe = self.n_layers // m.every_n_layers * (
            m.num_experts * 3 * self.d_model * m.d_ff_expert)
        active_moe = self.n_layers // m.every_n_layers * (
            m.top_k * 3 * self.d_model * m.d_ff_expert)
        return self.param_count() - full_moe + active_moe
