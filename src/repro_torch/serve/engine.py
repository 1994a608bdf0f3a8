"""Minimal serving engine: batched prefill + greedy decode loop.

Counterpart of ``src/repro/serve/engine.py:generate``, with the same
outputs: the prompt (after the vision front end's ``embeds``, where the
configuration has one) goes through one ``prefill`` (the
flash-attention kernel, once per attention layer; a mamba layer's
chunked scan), then ``max_new_tokens`` decode steps (dense rows over
the cache, a mamba layer's recurrent step), each token the argmax of
the logits over the real vocabulary (``logits[:, :vocab_size]``; the
first maximum on a tie, as ``jnp.argmax``).

The run happens on the card unless the caller asks otherwise:
``device=None`` means ``"cuda"`` and raises when no card is present.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cluster.api import resolve_device
from ..configs.base import ArchConfig
from ..models.model import decode_step, init_cache, prefill

__all__ = ["generate"]


def generate(params, cfg: ArchConfig, prompts, max_new_tokens: int = 16,
             embeds=None, device=None) -> np.ndarray:
    """Greedy generation.  prompts: (B, S) int token ids (numpy or a
    tensor) -> (B, max_new_tokens) int32 numpy.  ``embeds`` (B, n_front,
    frontend_dim), numpy or a tensor: the vision front end's patch
    embeddings, prepended to the prompt.  ``params`` must live on the
    run's device (``models.model.init_params``)."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"generate: parameters on {params['embed'].device}, "
                         f"the run on {dev}")
    tokens = torch.as_tensor(np.asarray(prompts), device=dev)
    if embeds is not None:
        embeds = torch.as_tensor(embeds, device=dev)
    b, s = tokens.shape
    front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    with torch.inference_mode():
        cache = init_cache(cfg, b, s + front + max_new_tokens, device=dev)
        logits, cache = prefill(params, cfg, tokens, cache, embeds)
        out = []
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = decode_step(params, cfg, tok, cache)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
