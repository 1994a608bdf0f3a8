"""End-to-end training loop: data pipeline -> step -> checkpoints.

Counterpart of ``src/repro/launch/train.py``, with its signature and
its fault-tolerance model:

* a checkpoint every ``ckpt_every`` steps (atomic rename), and one at
  the end;
* on start, resume from the latest checkpoint in ``ckpt_dir``;
* the data pipeline is stateless (step -> batch is pure), so a restart
  needs nothing beyond the step counter.

``mesh``: None, or a ``DeviceMesh`` (``launch.mesh.make_host_mesh``):
every rank builds the same weights and the same global batches from the
seed, as ``ProcessGroupSubstrate`` takes whole operands on every rank,
and keeps its shards (``launch.steps.shard_params`` / ``shard_batch``);
the moments follow the parameters, and a checkpoint is saved whole and
restored onto whatever mesh the run has.

Added: ``device`` (None: the card, raising without one), and
``params=`` / ``pipeline=``, which inject the initial parameters (a
tree of the port's layout, e.g. ``models.convert.
params_from_reference``'s; copied onto ``device``) and the batches (any
object with ``batch_at(step)`` returning {"tokens", "labels"} arrays
or tensors, e.g. the reference's own ``TokenPipeline``), as
``uniforms=`` injects draws elsewhere (ROADMAP C3).  Without them the
weights come from a ``torch.Generator`` seeded with ``seed`` on the
device and the batches from the port's ``data.TokenPipeline``.

    losses = train(smoke_config(get_arch("gemma-2b")), steps=100,
                   device="cpu")
"""
from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..ckpt import CheckpointManager
from ..device import resolve_device
from ..configs.base import ArchConfig
from ..configs.shapes import ShapeSpec
from ..data.pipeline import TokenPipeline
from ..models.convert import tree_map
from ..models.model import init_params
from ..optim.adamw import AdamWConfig, adamw_init, cosine_schedule
from .steps import build_train_step, shard_batch, shard_params

__all__ = ["train", "batch_on"]


def batch_on(data: dict, device) -> dict:
    """A batch's arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(device)
            for k, v in data.items()}


def train(cfg: ArchConfig, steps: int, *, mesh=None, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, warmup: int = 20,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          remat: str = "full", log_every: int = 10, seed: int = 0,
          device=None, params: Optional[Any] = None,
          pipeline: Optional[Any] = None) -> List[float]:
    """Train ``cfg`` for ``steps`` steps (resuming past the latest
    checkpoint in ``ckpt_dir``); returns the losses of the steps run."""
    dev = resolve_device(device)
    shape = ShapeSpec("train", "train", seq, batch)
    adamw = AdamWConfig(lr=lr)
    sched = lambda s: cosine_schedule(s, lr, warmup, steps)  # noqa: E731
    bundle = build_train_step(cfg, mesh, shape, remat=remat, adamw=adamw,
                              lr_schedule=sched)

    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                             dev)
    else:
        params = tree_map(lambda p: p.detach().to(dev).clone(), params)
    params = shard_params(bundle.rules, params)
    opt = adamw_init(params, adamw)
    start_step = 0
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None and manager.latest_step() is not None:
        start_step = manager.latest_step()
        state = manager.restore(start_step, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}")

    if pipeline is None:
        pipeline = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)
    losses: List[float] = []
    # monotonic: tok/s must survive wall-clock (NTP) steps mid-run
    t0 = time.monotonic()
    for step in range(start_step, steps):
        data = shard_batch(bundle.rules,
                           batch_on(pipeline.batch_at(step), dev))
        params, opt, metrics = bundle.fn(params, opt, data)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.monotonic() - t0
            tok_s = (step - start_step + 1) * batch * seq / max(dt, 1e-9)
            print(f"[train] step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"{tok_s:9.0f} tok/s")
        if manager is not None and (step + 1) % ckpt_every == 0:
            manager.save(step + 1, {"params": params, "opt": opt})
    if manager is not None:
        manager.save(steps, {"params": params, "opt": opt})
    return losses
