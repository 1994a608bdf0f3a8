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

:func:`opt_state_from_reference` does the same for the reference's
AdamW state ``{"step", "m", "v"}``: the moments unstacked into the
port's per-period layout in the moment dtype, the step an int32 scalar
-- so a test can hand both packages the same optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..configs.base import ArchConfig

__all__ = ["params_from_reference", "opt_state_from_reference", "tree_map",
           "tree_leaves"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


def _block(block: Dict[str, Any], i: int, dtype: torch.dtype, device,
           f32_leaves: bool = True):
    """Period ``i`` of one in-period position's stacked leaves, in
    ``dtype`` (with ``f32_leaves``, the leaves the reference keeps in
    float32 stay float32)."""
    out = tree_map(lambda a: _tensor(np.asarray(a)[i], dtype, device), block)
    for sub, names in (("moe", ("router",)),
                       ("mamba", ("A_log", "D", "dt_bias"))):
        for name in names if sub in block and f32_leaves else ():
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


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


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
    return _unstack(tree, cfg, cfg.param_dtype, device, True)


def _unstack(tree: Dict[str, Any], cfg: ArchConfig, dtype: torch.dtype,
             device, f32_leaves: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {name: _tensor(tree[name], dtype, device)
                           for name in sorted(set(tree) - {"periods"})}
    out["periods"] = [
        {str(pos): _block(tree["periods"][str(pos)], i, dtype, device,
                          f32_leaves)
         for pos in range(cfg.period)}
        for i in range(cfg.n_periods)]
    return out


def opt_state_from_reference(state: Dict[str, Any], cfg: ArchConfig,
                             moment_dtype: torch.dtype = torch.float32,
                             device=None) -> Dict[str, Any]:
    """The reference's AdamW state (leaves as numpy arrays) in the
    port's layout: "m" and "v" unstacked in ``moment_dtype``, "step" an
    int32 scalar, all on ``device`` (None: the card)."""
    device = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device),
            **{name: _unstack(state[name], cfg, moment_dtype, device, False)
               for name in ("m", "v")}}
