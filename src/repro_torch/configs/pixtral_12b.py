"""pixtral-12b [vlm] — pixtral-ViT frontend + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H
(GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.  The vision frontend
is a stub, as in the reference: the caller hands in 256 precomputed
1024-d patch embeddings (``embeds=`` on ``models.model.prefill`` and
``serve.generate``), which the learned ``frontend_proj`` lifts to
d_model and prepends to the token rows.  About 12.2 G parameters,
24.5 GB in bf16.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    act="swiglu",
    frontend="vision",
    n_frontend_tokens=256,
    frontend_dim=1024,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)
