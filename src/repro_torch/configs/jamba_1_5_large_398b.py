"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536.  Period 8: attention at position 0, Mamba elsewhere; MoE
replaces the MLP every 2nd layer.  Jamba ships Mamba-1 mixers; the
reference's SSM substrate, and so the port's (``models/ssm.py``), is
the Mamba-2 SSD with head_dim 128.  About 398 G parameters, ~800 GB in
bf16: one card serves a cut of its depth only (``chip_smoke.py``).
"""
from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    act="swiglu",
    period=8,
    attn_positions=(0,),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  every_n_layers=2, dispatch="alpha_k", extra_slots=16),
    ssm=SSMConfig(d_state=128, head_dim=128, expand=2, conv_width=4,
                  chunk=256),
    max_seq_len=262_144,
    sub_quadratic=True,
    notes="1 attn : 7 mamba interleave; MoE every 2 layers",
)
