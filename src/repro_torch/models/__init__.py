"""The LM stack of the port (counterpart of ``repro.models``): the
serving path -- layers, attention through the flash-attention kernel
(and the reference's blockwise backend in plain torch), the MoE layer
with its (alpha, k)-balanced dispatch, the Mamba-2 SSD mixer, the
decoder with its KV cache (bf16 or int8) and vision front end, and the
carry-over of the reference's parameters."""
from . import attention, convert, layers, model, moe, ssm

__all__ = ["attention", "convert", "layers", "model", "moe", "ssm"]
