"""gemma-2b [dense] — GeGLU, head_dim=256, MQA.  [arXiv:2403.08295; hf]

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=8_192,
    notes="MQA; 8 q-heads do not divide a 16-way model axis — attention "
          "shards the merged head*dim projection and sequence instead",
)
