"""AdamW + cosine schedule + global-norm clipping.

Counterpart of ``src/repro/optim/adamw.py``.  The state is the
reference's ``{"step", "m", "v"}``, ``m`` and ``v`` trees of the
parameters' shape in ``moment_dtype`` (float32, or bfloat16 to halve
them).  Each leaf's update is the reference's float32 arithmetic in its
order (``adamw.py:53-87``): the gradients scaled by the clip factor in
their own dtype, the moments' decay and the new gradient's share, the
bias corrections as float32 scalars on the device (a true division,
ROADMAP C6), weight decay on leaves of two or more dimensions only.

What differs: the update is in place, one leaf at a time.  The
reference's jitted step donates its parameter and state buffers, so
XLA writes the new values over the old; eager torch would hold the old
and the new trees at once (twice gemma-2b's 5.0 GB of weights and 20.1
GB of moments).  Here each leaf is written back as soon as it is
computed, through at most three float32 temporaries of that leaf's
size (the embedding's 524 M values: ~6.3 GB), and the parameter and
moment tensors keep their identity.  ``adamw_update`` returns the same
trees it was given, updated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import torch

from ..models.convert import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32


def cosine_schedule(step: Union[int, torch.Tensor], base_lr: float,
                    warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step``: linear warm-up to ``base_lr``, then
    a cosine down to ``min_frac`` of it at ``total``; float32, divided
    by device tensors (a true division on the card too, ROADMAP C6)."""
    step = torch.as_tensor(step).float()

    def over(a: torch.Tensor, n: int) -> torch.Tensor:
        return a / torch.full((), float(n), device=a.device)

    warm = over(base_lr * step, max(1, warmup))
    prog = torch.clamp(over(step - warmup, max(1, total - warmup)), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()):
    """Zeroed moments in ``cfg.moment_dtype`` beside each parameter, and
    the step count, an int32 scalar on the parameters' device."""
    def zeros(p: torch.Tensor) -> torch.Tensor:
        # zeros_like: a DTensor parameter's moments are laid out as it is
        return torch.zeros_like(p, dtype=cfg.moment_dtype,
                                memory_format=torch.contiguous_format)

    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree, reduce=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    added leaf by leaf as the reference's Python ``sum``.  ``reduce``
    (on a mesh) maps the (leaves,) local sums of squares of local shards
    to the whole leaves' sums (``launch.steps``)."""
    sqs = [torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)]
    if reduce is not None:
        sqs = list(reduce(torch.stack(sqs)).unbind())
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, scale: Optional[torch.Tensor],
                 bc1: torch.Tensor, bc2: torch.Tensor, lr,
                 cfg: AdamWConfig) -> None:
    """One leaf, in place: the reference's ``upd`` (``adamw.py:72-83``)."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    a = g.to(torch.float32, copy=True)               # g32
    m32 = m if m.dtype == torch.float32 else m.float()
    v32 = v if v.dtype == torch.float32 else v.float()
    t = a * (1 - cfg.b1)
    m32.mul_(cfg.b1).add_(t)                         # m*b1 + (1-b1)*g32
    torch.mul(a, 1 - cfg.b2, out=t).mul_(a)          # (1-b2)*g32*g32
    v32.mul_(cfg.b2).add_(t)
    torch.div(v32, bc2, out=a).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
    torch.div(m32, bc1, out=t).div_(a)               # delta = mhat / ...
    p32 = p if p.dtype == torch.float32 else p.float()
    if p.dim() >= 2:                                 # decay matrices only
        t.add_(torch.mul(p32, cfg.weight_decay, out=a))
    p32.sub_(t.mul_(lr))                             # p32 - lr * delta
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


def adamw_update(params, grads, state, cfg: AdamWConfig = AdamWConfig(),
                 lr: Optional[Union[float, torch.Tensor]] = None,
                 norm_reduce=None) -> Tuple[Any, Any, torch.Tensor]:
    """One AdamW step, in place.  Returns (params, state, grad_norm): the
    trees given, updated, ``state["step"]`` replaced by step + 1, and
    the float32 global norm of ``grads`` before clipping (``norm_reduce``
    as :func:`global_norm`'s ``reduce``, where the trees are a rank's
    local shards)."""
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    if isinstance(lr, torch.Tensor):
        lr = lr.to(device=step.device, dtype=torch.float32)
    gnorm = global_norm(grads, norm_reduce)
    scale = None
    if cfg.clip_norm is not None:
        clip = torch.full((), cfg.clip_norm, dtype=torch.float32,
                          device=gnorm.device)
        scale = torch.clamp(clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    f32 = dict(dtype=torch.float32, device=step.device)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, **f32), step.float())
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, **f32), step.float())
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        _update_leaf(p, g, m, v, scale, bc1, bc2, lr, cfg)
    state["step"] = step
    return params, state, gnorm
