"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8,
head_dim=128) per-expert d_ff=10752 vocab=100352.  131.6 G parameters,
about 263 GB in bf16: more than one 80 GB card holds whole.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100_352,
    act="swiglu",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752,
                  every_n_layers=1, dispatch="alpha_k", extra_slots=16),
    rope_theta=500_000.0,
    max_seq_len=32_768,
)
