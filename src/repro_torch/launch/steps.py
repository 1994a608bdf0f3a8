"""Step builders (train / prefill / decode) as plain closures.

Counterpart of ``src/repro/launch/steps.py`` (``StepBundle``,
``build_train_step``, ``build_prefill_step``, ``build_decode_step``,
``build_step``).  The reference jits each step with in/out shardings
from ``sharding/specs.py`` for a mesh, and donates the parameter and
state buffers.  Here there is no jit and no sharding: each step is a
function of the port's eager modules, and the optimizer writes the new
parameters and moments over the old ones (``optim/adamw.py``), which
is what the donation buys the reference.  A ``mesh`` other than None
raises: the multi-card substrate is ROADMAP A7.

``StepBundle.arg_shapes`` holds the step's arguments laid out on the
meta device (``models.model.params_shape``, ``configs.input_specs``):
shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeSpec, input_specs
from ..models.convert import tree_leaves, tree_map
from ..models.model import (decode_step, params_shape, prefill,
                            train_loss)
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["StepBundle", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_step"]


class StepBundle:
    """A step function and its arguments' meta-device stand-ins."""

    def __init__(self, fn: Callable, arg_shapes: Tuple):
        self.fn = fn
        self.arg_shapes = arg_shapes


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("repro_torch runs on one card: a device mesh (and "
                         "the sharding rules that go with it) is ROADMAP "
                         "A7, the multi-process substrate; pass mesh=None")


def build_train_step(cfg: ArchConfig, mesh, shape: ShapeSpec, *,
                     remat: str = "full", loss_chunk: int = 512,
                     adamw: AdamWConfig = AdamWConfig(),
                     lr_schedule: Optional[Callable] = None) -> StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``: the loss and its gradient by autograd, then one
    AdamW step at ``lr_schedule(opt_state["step"])`` (``adamw.lr``
    without a schedule), in place."""
    _no_mesh(mesh)

    def step_fn(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = train_loss(params, cfg, batch, remat=remat,
                          loss_chunk=loss_chunk)
        # a leaf the batch does not reach (the vision projection without
        # embeds) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grad_tree = _regroup(params, iter(grads))
        lr = (lr_schedule(opt_state["step"]) if lr_schedule is not None
              else adamw.lr)
        with torch.no_grad():
            params, opt_state, gnorm = adamw_update(params, grad_tree,
                                                    opt_state, cfg=adamw,
                                                    lr=lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    pshape = params_shape(cfg)
    oshape = adamw_init(pshape, adamw)
    return StepBundle(step_fn, (pshape, oshape, input_specs(cfg, shape)))


def _regroup(like, leaves):
    """``like``'s structure with its leaves taken in ``tree_map`` order."""
    return tree_map(lambda _: next(leaves), like)


def build_prefill_step(cfg: ArchConfig, mesh, shape: ShapeSpec
                       ) -> StepBundle:
    """``fn(params, tokens, cache, embeds=None) -> (logits, cache)``:
    ``models.model.prefill`` without gradients."""
    _no_mesh(mesh)
    specs = input_specs(cfg, shape)

    def step_fn(params, tokens, cache, embeds=None):
        with torch.no_grad():
            return prefill(params, cfg, tokens, cache, embeds=embeds)

    args = [params_shape(cfg), specs["tokens"], specs["cache"]]
    if cfg.frontend == "vision":
        args.append(specs["embeds"])
    return StepBundle(step_fn, tuple(args))


def build_decode_step(cfg: ArchConfig, mesh, shape: ShapeSpec
                      ) -> StepBundle:
    """``fn(params, token, cache) -> (logits, cache)``:
    ``models.model.decode_step`` without gradients."""
    _no_mesh(mesh)
    specs = input_specs(cfg, shape)

    def step_fn(params, token, cache):
        with torch.no_grad():
            return decode_step(params, cfg, token, cache)

    return StepBundle(step_fn, (params_shape(cfg), specs["token"],
                                specs["cache"]))


def build_step(cfg: ArchConfig, mesh, shape: ShapeSpec, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)
