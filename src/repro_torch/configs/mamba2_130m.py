"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768 d_ff=0 vocab=50280
(padded 50432), ssm_state=128.  head_dim=96 (so n_heads = 2*768/96 = 16
divides the 16-way model axis of the reference's mesh -- a recorded
hardware adaptation there, kept here so that both packages hold the
same model; the paper default is 64).  O(1) decode state: the mixer is
``models/ssm.py``'s chunked SSD scan in prefill and its recurrent step
in decode.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=96, expand=2, conv_width=4,
                  chunk=256),
    tie_embeddings=True,
    max_seq_len=1_048_576,
    sub_quadratic=True,
)
