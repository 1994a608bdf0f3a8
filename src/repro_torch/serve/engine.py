"""Minimal serving engine: batched prefill + greedy decode loop.

Counterpart of ``src/repro/serve/engine.py:generate``, with the same
outputs: the prompt goes through one ``prefill`` (the flash-attention
kernel, once per attention layer), then ``max_new_tokens`` decode steps
(dense rows over the cache), each token the argmax of the logits over
the real vocabulary (``logits[:, :vocab_size]``; the first maximum on a
tie, as ``jnp.argmax``).

The run happens on the card unless the caller asks otherwise:
``device=None`` means ``"cuda"`` and raises when no card is present.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cluster.api import resolve_device
from ..configs.base import ArchConfig
from ..models.model import check_served, decode_step, init_cache, prefill

__all__ = ["generate"]


def generate(params, cfg: ArchConfig, prompts, max_new_tokens: int = 16,
             device=None) -> np.ndarray:
    """Greedy generation.  prompts: (B, S) int token ids (numpy or a
    tensor) -> (B, max_new_tokens) int32 numpy.  ``params`` must live on
    the run's device (``models.model.init_params``)."""
    check_served(cfg)
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"generate: parameters on {params['embed'].device}, "
                         f"the run on {dev}")
    tokens = torch.as_tensor(np.asarray(prompts), device=dev)
    b, s = tokens.shape
    with torch.inference_mode():
        cache = init_cache(cfg, b, s + max_new_tokens, device=dev)
        logits, cache = prefill(params, cfg, tokens, cache)
        out = []
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = decode_step(params, cfg, tok, cache)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
