"""The LM stack of the port (counterpart of ``repro.models``): the
serving path -- layers, attention through the flash-attention kernel,
the MoE layer with its (alpha, k)-balanced dispatch, the decoder with
its KV cache, and the carry-over of the reference's parameters."""
from . import attention, convert, layers, model, moe

__all__ = ["attention", "convert", "layers", "model", "moe"]
