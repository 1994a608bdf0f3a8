"""musicgen-medium [audio] -- decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

48L d_model=1536 24H (kv=24: full MHA, head_dim=64) d_ff=6144
vocab=2048.  The port's copy of ``src/repro/configs/musicgen_medium.py``:
the EnCodec front end is a stub there, the model consumes precomputed
audio codes directly, so both serve it as a plain dense decoder (the
model branches on the vision front end only, ``models/model.py``).  MusicGen's MLP is plain GELU; the
reference's gated GeGLU at the same d_ff stands in for it.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="geglu",
    frontend="audio",
    max_seq_len=8_192,
    notes="24 heads -> merged-dim TP; EnCodec codes consumed directly",
)
