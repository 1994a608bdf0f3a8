"""Step builders (train / prefill / decode) as plain closures.

Counterpart of ``src/repro/launch/steps.py`` (``StepBundle``,
``build_train_step``, ``build_prefill_step``, ``build_decode_step``,
``build_step``).  The reference jits each step with in/out shardings
from ``sharding/specs.py`` for a mesh, and donates the parameter and
state buffers.  Here there is no jit: each step is a function of the
port's eager modules, and the optimizer writes the new parameters and
moments over the old ones (``optim/adamw.py``), which is what the
donation buys the reference.

``mesh``: None (one device), or a ``DeviceMesh`` (``launch.mesh``)
whose axes the rules read (``StepBundle.rules``, the reference's).  On
a mesh the step's parameters, moments and cache are DTensors laid out
by the rules' specs and its batch by ``rules.batch_spec``
(:func:`shard_params`, :func:`shard_opt_state`, :func:`shard_cache`,
:func:`shard_batch`: every rank holds the whole tree and keeps its
shards); the model's sub-blocks run on local shards
(``sharding/parallel.py``).  The train step sums the gradients of the
parameters a batch axis replicates over that axis (data parallelism),
updates each rank's shards in place, and reports the loss and the
global gradient norm, replicated: whole reductions over the mesh.

``StepBundle.arg_shapes`` holds the step's arguments laid out on the
meta device (``models.model.params_shape``, ``configs.input_specs``):
global shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeSpec, input_specs
from ..models.convert import tree_leaves, tree_map
from ..models.model import (decode_step, params_shape, prefill,
                            train_loss)
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..sharding.parallel import Par, all_reduce_, distribute, local
from ..sharding.specs import P, ShardingRules, make_rules

__all__ = ["StepBundle", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_step", "rules_for", "shard_params",
           "shard_opt_state", "shard_cache", "shard_batch",
           "train_input_sharding"]


class StepBundle:
    """A step function, its arguments' meta-device stand-ins and the
    sharding rules it runs under."""

    def __init__(self, fn: Callable, arg_shapes: Tuple,
                 rules: ShardingRules):
        self.fn = fn
        self.arg_shapes = arg_shapes
        self.rules = rules


def rules_for(cfg: ArchConfig, mesh, *, seq_parallel: bool = False,
              fsdp_threshold: int = 10_000_000_000) -> ShardingRules:
    """The rules of ``mesh``: None, or a ``DeviceMesh`` (anything else
    raises TypeError); ``seq_parallel`` and ``fsdp_threshold`` as
    ``make_rules`` takes them."""
    if mesh is None:
        return make_rules(None, cfg)
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_host_mesh / "
                        f"make_production_mesh) or None, got "
                        f"{type(mesh).__name__}")
    return make_rules(mesh, cfg, fsdp_threshold, seq_parallel=seq_parallel)


def shard_params(rules: ShardingRules, params):
    """The parameter tree as DTensors laid out by the rules' specs (as
    it is without a mesh); a shard no axis splits is the tensor given
    (``sharding.parallel.distribute``)."""
    if rules.mesh is None:
        return params
    return distribute(params, rules.param_specs(params), rules.mesh)


def shard_opt_state(rules: ShardingRules, opt):
    """AdamW's state: the moments laid out as their parameters, the
    step count replicated."""
    if rules.mesh is None:
        return opt
    specs = rules.param_specs(opt["m"])
    return {"step": opt["step"],
            "m": distribute(opt["m"], specs, rules.mesh),
            "v": distribute(opt["v"], specs, rules.mesh)}


def shard_cache(rules: ShardingRules, cache):
    """The serving cache laid out by ``rules.cache_specs``."""
    if rules.mesh is None:
        return cache
    return distribute(cache, rules.cache_specs(cache), rules.mesh)


def train_input_sharding(cfg: ArchConfig, rules: ShardingRules,
                         batch: int) -> dict:
    """The batch's specs: tokens and labels by ``rules.batch_spec``, and
    a vision front end's (B, n, d) embeds over the same batch axes."""
    spec = {"tokens": rules.batch_spec(batch),
            "labels": rules.batch_spec(batch)}
    if cfg.frontend == "vision":
        spec["embeds"] = P(rules.batch_spec(batch)[0], None, None)
    return spec


def shard_batch(rules: ShardingRules, batch: dict) -> dict:
    """A batch's tensors {"tokens", "labels", "embeds"}, each (B, ...),
    laid out by :func:`train_input_sharding` for the rules' config."""
    if rules.mesh is None:
        return batch
    return {k: distribute(v, tuple(train_input_sharding(
                rules._cfg, rules, v.shape[0])[k]), rules.mesh)
            for k, v in batch.items()}


def _regroup(like, leaves):
    """``like``'s structure with its leaves taken in ``tree_map`` order."""
    return tree_map(lambda _: next(leaves), like)


def _mesh_grads(grads, leaves, par: Par):
    """Local gradients, each summed over the batch axes that replicate
    its parameter (an FSDP shard's was summed by its gather)."""
    from torch.distributed.tensor import Replicate
    out = []
    for g, p in zip(grads, leaves):
        g = local(g)
        for mdim, group in par.data_axes.items():
            if isinstance(p.placements[mdim], Replicate):
                all_reduce_(g, group)
        out.append(g)
    return out


def _norm_reduce(leaves, mesh):
    """The (leaves,) local sums of squares -> the whole leaves': summed
    over each mesh axis that shards a leaf."""
    from torch.distributed.tensor import Shard
    axes = []
    for mdim in range(mesh.ndim):
        flags = [isinstance(p.placements[mdim], Shard) for p in leaves]
        if mesh.size(mdim) > 1 and any(flags):
            axes.append((mesh.get_group(mdim), flags))

    def reduce(sq: torch.Tensor) -> torch.Tensor:
        for group, flags in axes:
            mask = torch.tensor(flags, device=sq.device)
            part = torch.where(mask, sq, 0.0)
            dist.all_reduce(part, group=group)
            sq = torch.where(mask, part, sq)
        return sq

    return reduce


def build_train_step(cfg: ArchConfig, mesh, shape: ShapeSpec, *,
                     remat: str = "full", loss_chunk: int = 512,
                     adamw: AdamWConfig = AdamWConfig(),
                     lr_schedule: Optional[Callable] = None,
                     **mesh_kw) -> StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``: the loss and its gradient by autograd, then one
    AdamW step at ``lr_schedule(opt_state["step"])`` (``adamw.lr``
    without a schedule), in place.  ``mesh_kw``: :func:`rules_for`'s."""
    rules = rules_for(cfg, mesh, **mesh_kw)
    par = Par(rules)

    def step_fn(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = train_loss(params, cfg, batch, remat=remat,
                          loss_chunk=loss_chunk,
                          rules=None if mesh is None else rules)
        # a leaf the batch does not reach (the vision projection without
        # embeds) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        lr = (lr_schedule(opt_state["step"]) if lr_schedule is not None
              else adamw.lr)
        loss = loss.detach()
        if par.mesh is None:
            with torch.no_grad():
                params, opt_state, gnorm = adamw_update(
                    params, _regroup(params, iter(grads)), opt_state,
                    cfg=adamw, lr=lr)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}
        with torch.no_grad():
            grads = _mesh_grads(grads, leaves, par)
            loss = par.batch_sum_(loss.clone())
            state = {"step": opt_state["step"],
                     "m": tree_map(local, opt_state["m"]),
                     "v": tree_map(local, opt_state["v"])}
            local_params = tree_map(local, params)
            _, state, gnorm = adamw_update(
                local_params, _regroup(params, iter(grads)), state,
                cfg=adamw, lr=lr, norm_reduce=_norm_reduce(leaves, par.mesh))
            opt_state["step"] = state["step"]
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    pshape = params_shape(cfg)
    oshape = adamw_init(pshape, adamw)
    return StepBundle(step_fn, (pshape, oshape, input_specs(cfg, shape)),
                      rules)


def build_prefill_step(cfg: ArchConfig, mesh, shape: ShapeSpec,
                       **mesh_kw) -> StepBundle:
    """``fn(params, tokens, cache, embeds=None) -> (logits, cache)``:
    ``models.model.prefill`` without gradients."""
    rules = rules_for(cfg, mesh, **mesh_kw)
    specs = input_specs(cfg, shape)

    def step_fn(params, tokens, cache, embeds=None):
        with torch.no_grad():
            return prefill(params, cfg, tokens, cache, embeds=embeds,
                           rules=None if mesh is None else rules)

    args = [params_shape(cfg), specs["tokens"], specs["cache"]]
    if cfg.frontend == "vision":
        args.append(specs["embeds"])
    return StepBundle(step_fn, tuple(args), rules)


def build_decode_step(cfg: ArchConfig, mesh, shape: ShapeSpec,
                      **mesh_kw) -> StepBundle:
    """``fn(params, token, cache) -> (logits, cache)``:
    ``models.model.decode_step`` without gradients."""
    rules = rules_for(cfg, mesh, **mesh_kw)
    specs = input_specs(cfg, shape)

    def step_fn(params, token, cache):
        with torch.no_grad():
            return decode_step(params, cfg, token, cache,
                               rules=None if mesh is None else rules)

    return StepBundle(step_fn, (params_shape(cfg), specs["token"],
                                specs["cache"]), rules)


def build_step(cfg: ArchConfig, mesh, shape: ShapeSpec, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)
