"""The LM stack of the port (counterpart of ``repro.models``): layers
and the chunked cross-entropy, attention through the flash-attention
kernel (differentiated through the reference's blockwise backend in
plain torch), the MoE layer with its (alpha, k)-balanced dispatch, the
Mamba-2 SSD mixer, the decoder's training forward and loss and its
serving path with a KV cache (bf16 or int8) and vision front end, and
the carry-over of the reference's parameters and optimizer state."""
from . import attention, convert, layers, model, moe, ssm
from .model import (decode_step, forward, init_cache, init_params,
                    params_shape, prefill, train_loss)

__all__ = ["attention", "convert", "layers", "model", "moe", "ssm",
           "decode_step", "forward", "init_cache", "init_params",
           "params_shape", "prefill", "train_loss"]
