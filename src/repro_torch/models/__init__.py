"""The LM stack of the port (counterpart of ``repro.models``): the dense
serving path -- layers, attention through the flash-attention kernel,
the decoder with its KV cache, and the carry-over of the reference's
parameters."""
from . import attention, convert, layers, model

__all__ = ["attention", "convert", "layers", "model"]
