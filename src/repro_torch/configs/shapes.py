"""The four assigned input shapes and their stand-in inputs.

Counterpart of ``src/repro/configs/shapes.py``: ``ShapeSpec``,
``SHAPES``, ``applicable`` and ``skip_reason`` as the reference has
them.  :func:`input_specs` returns tensors on the meta device in place
of ``jax.ShapeDtypeStruct``: each input's shape and dtype, nothing
allocated; a decode shape's cache is the port's ``init_cache`` laid out
on the meta device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .base import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "input_specs", "applicable",
           "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if applicable(cfg, shape):
        return None
    return (f"{cfg.name} is pure full-attention (not sub-quadratic): "
            f"long_500k requires SSM/hybrid/sliding-window archs")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, object]:
    """Meta-device stand-ins for every model input.  Train: "tokens" and
    "labels" (B, S - n_front) int32 (and "embeds" with a vision front
    end); prefill: "tokens", the vision "embeds" and the "cache" for S
    positions; decode: one "token" (B, 1) against a "cache" of S."""
    from ..models.model import init_cache

    b, s = shape.global_batch, shape.seq_len
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0

    def tok(bb, ss):
        return torch.empty((bb, ss), dtype=torch.int32, device="meta")

    def embeds():
        return torch.empty((b, cfg.n_frontend_tokens, cfg.frontend_dim),
                           dtype=torch.bfloat16, device="meta")

    if shape.kind == "train":
        specs: Dict[str, object] = {"tokens": tok(b, s - n_front),
                                    "labels": tok(b, s - n_front)}
        if n_front:
            specs["embeds"] = embeds()
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": tok(b, s - n_front)}
        if n_front:
            specs["embeds"] = embeds()
        specs["cache"] = init_cache(cfg, b, s, device="meta")
        return specs
    # decode: one token against a seq_len cache
    return {"token": tok(b, 1),
            "cache": init_cache(cfg, b, s, device="meta")}
