"""Carry the reference model's parameters over to the port.

The reference's ``init_params`` returns a pytree whose per-layer leaves
under ``params["periods"][str(pos)]`` carry a leading ``n_periods``
axis (the axis its ``lax.scan`` runs over).  The port keeps one dict
per period (``models/model.py``).  :func:`params_from_reference` takes
that pytree with numpy arrays as leaves (``np.asarray`` of each jax
array) and returns the port's parameters on ``device`` (None: the card,
raising without one, as every entry point of the port) in
``cfg.param_dtype`` (a MoE router and a Mamba mixer's ``A_log``, ``D``
and ``dt_bias`` in float32, as the reference holds them): the periods
unstacked -- a period of jamba holds attention and mamba positions side
by side --, ``unembed`` present only without tied embeddings,
``frontend_proj`` only with the vision front end, the embedding at the
padded vocab as the reference holds it.  bfloat16 leaves (numpy's ``ml_dtypes`` type) go
through float32, which holds them exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..cluster.api import resolve_device
from ..configs.base import ArchConfig

__all__ = ["params_from_reference", "tree_map"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


def _block(block: Dict[str, Any], i: int, cfg: ArchConfig, device):
    """Period ``i`` of one in-period position's stacked leaves."""
    out = tree_map(lambda a: _tensor(np.asarray(a)[i], cfg.param_dtype,
                                     device), block)
    for sub, names in (("moe", ("router",)),
                       ("mamba", ("A_log", "D", "dt_bias"))):
        for name in names if sub in block else ():
            out[sub][name] = _tensor(np.asarray(block[sub][name])[i],
                                     torch.float32, device)
    return out


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists, in the
    tree's shape (the port's parameters and caches are such trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_reference(tree: Dict[str, Any], cfg: ArchConfig,
                          device=None) -> Dict[str, Any]:
    device = resolve_device(device)
    want = ({"embed", "final_norm", "periods"}
            | (set() if cfg.tie_embeddings else {"unembed"})
            | ({"frontend_proj"} if cfg.frontend == "vision" else set()))
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: reference parameters {sorted(tree)}, "
                         f"expected {sorted(want)}")
    embed = np.asarray(tree["embed"])
    if embed.shape != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed {embed.shape}, expected "
                         f"{(cfg.padded_vocab, cfg.d_model)}")
    params: Dict[str, Any] = {
        name: _tensor(tree[name], cfg.param_dtype, device)
        for name in sorted(want - {"periods"})}
    params["periods"] = [
        {str(pos): _block(tree["periods"][str(pos)], i, cfg, device)
         for pos in range(cfg.period)}
        for i in range(cfg.n_periods)]
    return params
