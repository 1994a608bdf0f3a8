"""llama3-405b [dense] — GQA, 128k vocab.  [arXiv:2407.21783; unverified]

126L d_model=16384 128H (kv=8, head_dim=128) d_ff=53248 vocab=128256.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128_256,
    act="swiglu",
    rope_theta=500_000.0,
    max_seq_len=131_072,
)
