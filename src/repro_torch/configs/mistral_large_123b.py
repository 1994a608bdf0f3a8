"""mistral-large-123b [dense].  [hf:mistralai/Mistral-Large-Instruct-2407]

88L d_model=12288 96H (GQA kv=8, head_dim=128) d_ff=28672 vocab=32768.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32_768,
    act="swiglu",
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)
