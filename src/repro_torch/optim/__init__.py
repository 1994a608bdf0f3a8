"""Optimizer of the port (counterpart of ``repro.optim``): AdamW with
the cosine schedule and global-norm clipping, and int8 gradient
compression with error feedback."""
from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .grad_compress import (compress_decompress, compress_state_init,
                            compressed_psum)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_decompress", "compress_state_init", "compressed_psum"]
