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

``rules`` (``sharding.make_rules`` of a ``DeviceMesh``), as the
reference's ``generate(..., rules=None)``: the parameters are DTensors
laid out by its specs (``launch.steps.shard_params``), every rank passes
the whole prompts, the cache is laid out by ``rules.cache_specs``, and
every rank gets the whole (B, max_new_tokens) tokens back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..configs.base import ArchConfig
from ..models.model import decode_step, init_cache, prefill

__all__ = ["generate"]


def generate(params, cfg: ArchConfig, prompts, max_new_tokens: int = 16,
             embeds=None, device=None, rules=None) -> np.ndarray:
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
    mesh = None if rules is None else rules.mesh
    if mesh is None:
        rules = None
    with torch.inference_mode():
        cache = init_cache(cfg, b, s + front + max_new_tokens, device=dev)
        if mesh is not None:
            from ..launch.steps import shard_cache
            cache = shard_cache(rules, cache)
        logits, cache = prefill(params, cfg, tokens, cache, embeds,
                                rules=rules)
        out = []
        tok = _next(logits, cfg)
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = decode_step(params, cfg, tok, cache, rules=rules)
            tok = _next(logits, cfg)
        out = torch.cat(out, dim=1).to(torch.int32)
        if mesh is not None:
            out = out.full_tensor()
    return out.cpu().numpy()


def _next(logits, cfg: ArchConfig):
    """The greedy token of each row, (B, 1); on a mesh a DTensor of the
    logits' batch layout."""
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        tok = _next(logits.to_local(), cfg)
        return DTensor.from_local(tok, logits.device_mesh, logits.placements,
                                  run_check=False,
                                  shape=(logits.shape[0], 1), stride=(1, 1))
    return torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
