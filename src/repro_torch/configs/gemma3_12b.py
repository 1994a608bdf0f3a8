"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; unverified]  48L d_model=3840 16H
(GQA kv=8, head_dim=256) d_ff=15360 vocab=262144.  Period 6: five
1024-token sliding-window layers then one global layer — sub-quadratic
in the local layers, so long_500k runs for this arch.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262_144,
    act="geglu",
    period=6,
    global_attn_positions=(5,),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=131_072,
    sub_quadratic=True,
    notes="5 local (sw=1024) : 1 global pattern",
)
