"""int8 gradient compression with error feedback.

Counterpart of ``src/repro/optim/grad_compress.py``: each leaf's
gradient plus its residual is quantized to int8 under one float32 scale
(``max|x| / 127 + 1e-12``), and the residual keeps what the rounding
lost: e_{t+1} = g_t + e_t - Q(g_t + e_t).

``compressed_psum`` is the reference's shard_map building block.  The
port has no named axes: it runs over the batched substrate's machine
axis, ``x`` and ``residual`` of shape (t, ...), machine i in row i.
Each machine's int8 rows and its scale are what cross the links: they
go through ``CollectiveTape.all_gather`` (where the reference calls
``lax.all_gather``), recorded on ``tape`` when one is given, and each
contribution is dequantized with its own scale before the sum.

The arithmetic is the reference's op by op, each a float32 rounding: a
true division of the largest magnitude by 127 (the card divides by a
device tensor, ROADMAP C6), then the add.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..cluster.collectives import CollectiveTape
from ..models.convert import tree_map

__all__ = ["compress_state_init", "compress_decompress", "compressed_psum"]


def compress_state_init(params):
    """Error-feedback residuals, one float32 zero tensor per leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return amax / torch.full((), 127.0, device=amax.device) + 1e-12


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values of x and their float32 scale, max|x| / 127 + 1e-12;
    ``round`` half to even, as ``jnp.round``."""
    scale = _scale(torch.amax(torch.abs(x)))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, residuals):
    """Quantize grad + residual to int8; return (dequantized grads in
    each gradient's dtype, new residuals)."""
    def one(g, e):
        x = g.float() + e
        q, scale = _quantize(x)
        d = q.float() * scale
        return d.to(g.dtype), x - d

    pairs = _zip_map(one, grads, residuals)
    deq = tree_map(lambda pr: pr[0], pairs)
    res = tree_map(lambda pr: pr[1], pairs)
    return deq, res


def _zip_map(fn, a, b):
    """``fn`` over the leaves of two trees of one structure: a tree of
    its results (a tuple is a leaf to ``tree_map``)."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def compressed_psum(x: torch.Tensor, residual: torch.Tensor,
                    tape: Optional[CollectiveTape] = None):
    """int8 all-reduce with error feedback over the machine axis.

    x, residual: (t, ...), machine i's operand in row i.  Returns (the
    mean over machines, as every machine sees it, (t, ...) in x's
    dtype; the new (t, ...) float32 residuals)."""
    t = x.shape[0]
    val = x.float() + residual
    flat = val.reshape(t, -1)
    scale = _scale(torch.amax(torch.abs(flat), dim=1))           # (t,)
    shape = (t,) + (1,) * (x.dim() - 1)
    q = torch.clamp(torch.round(val / scale.reshape(shape)), -127,
                    127).to(torch.int8)
    tape = tape if tape is not None else CollectiveTape()
    all_q = tape.all_gather(q.reshape(t, -1))        # (t, ...) int8 wire
    all_scale = tape.all_gather(scale[:, None], track=False)   # (t, 1)
    parts = all_q.float() * all_scale
    approx = parts[0]
    for part in parts[1:]:          # machine by machine, as XLA's reduce
        approx = approx + part
    new_residual = val - q.float() * scale.reshape(shape)
    mean = (approx / torch.full((), float(t), device=x.device)).to(x.dtype)
    return (mean.reshape(x.shape[1:]).expand(x.shape).clone(),
            new_residual)
