"""granite-moe-3b-a800m [moe] — fine-grained 40-expert top-8.

[hf:ibm-granite/granite-3.0 family; hf]  32L d_model=1536 24H (GQA kv=8,
head_dim=64) per-expert d_ff=512, vocab=49155 (padded to 49408).  Every
layer's FFN is a MoE layer: 40 experts, top-8, 8 extra StatJoin slots
(``models/moe.py``).  3.30 G parameters, 0.88 G active a token.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    act="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                  every_n_layers=1, dispatch="alpha_k", extra_slots=8),
    tie_embeddings=True,
    max_seq_len=8_192,
    notes="40 experts top-8 fine-grained",
)
