"""Tensor parallelism on local shards: the collectives at a sub-block's
edges and the context the model threads through its blocks.

The reference leaves the per-op layout to GSPMD.  The port runs each
sub-block eagerly on the rank's local shards, in the layout
``sharding/specs.py`` chose, with every collective explicit (torch's
op-by-op DTensor propagation breaks on the model's constant tensors, and
the hand kernels take plain tensors).  Parameters rest as DTensors laid
out by their specs; a block reads its local shard (``Par.w``: the
'model' shard stays local, an FSDP 'data' shard is gathered).

Gradients follow one convention a mesh axis:

* 'model' (Megatron's): a tensor replicated over 'model' carries the
  same, whole gradient on every rank.  :func:`copy_to` (identity,
  all-reduce backward) marks where a replicated tensor enters a region
  that each rank uses in its own way (column-parallel products, a
  replicated weight such as the router), :func:`reduce_from`
  (all-reduce, identity backward) where partial sums leave one (the
  row-parallel products), :func:`gather_from` (all-gather, slice
  backward) where shards become a replicated tensor that every rank
  uses alike, and :func:`gather_to` (all-gather, reduce-scatter
  backward) where they become one that each rank uses in its own way.
* the batch axes: each rank's gradient is its batch rows' share; the
  train step sums the gradients of the parameters replicated over a
  batch axis there (data parallelism), and an FSDP shard's gather sums
  its gradient in its backward (:func:`gather_to`).

Every function is a collective over its group (each rank calls it in
the same order); with a group of one rank it is the identity, so a
(1, 1) mesh runs the plain ops.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..cluster.compat import all_gather_rows

__all__ = ["Par", "copy_to", "reduce_from", "gather_from", "gather_to",
           "reduce_scatter", "split_to", "all_reduce_", "local", "distribute",
           "seq_chunks"]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group`` (no autograd)."""
    if _size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    all_gather_rows(out, xm, group=group)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = _size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, partial_grad):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial_grad
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _sum(g, ctx.group)
        return _chunk(g, ctx.dim, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(_sum(x, group), dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to(x, group):
    """Identity; the backward sums the ranks' partial gradients."""
    return x if _size(group) == 1 else _Copy.apply(x, group)


def reduce_from(x, group):
    """The sum of the ranks' partial ``x``; identity backward."""
    return x if _size(group) == 1 else _Reduce.apply(x, group)


def gather_from(x, dim: int, group):
    """The ranks' shards concatenated along ``dim``, then used alike on
    every rank: the backward keeps this rank's slice."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group, False)


def gather_to(x, dim: int, group):
    """The ranks' shards concatenated along ``dim``, then used by each
    rank in its own way: the backward reduce-scatters."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group, True)


def reduce_scatter(x, dim: int, group):
    """The ranks' partial ``x`` summed, this rank's slice along ``dim``
    kept; the backward all-gathers."""
    return x if _size(group) == 1 else _ReduceScatter.apply(x, dim, group)


def local(p):
    """A DTensor's local shard (differentiable); a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return p.to_local() if isinstance(p, DTensor) else p


class Par:
    """What a forward pass needs of the mesh: the 'model' group, its
    size ``m`` and this rank's index on it, the batch axes' groups, and
    whether the residual stream is sequence-parallel.  ``Par(None)`` (no
    rules, or rules without a mesh) is the one-device path."""

    def __init__(self, rules=None):
        self.rules = rules
        mesh = None if rules is None else rules.mesh
        self.mesh = mesh
        self.m, self.rank, self.group = 1, 0, None
        self.data_axes: dict = {}       # mesh dim -> group, batch axes
        self.seq_parallel = False
        if mesh is None:
            return
        names = tuple(mesh.mesh_dim_names)
        mdl = rules.model_axis
        if mdl in names and mesh.size(names.index(mdl)) > 1:
            self.m = mesh.size(names.index(mdl))
            self.rank = mesh.get_local_rank(mdl)
            self.group = mesh.get_group(mdl)
        for a in rules.batch_axes:
            if mesh.size(names.index(a)) > 1:
                self.data_axes[names.index(a)] = mesh.get_group(a)
        self.seq_parallel = bool(rules.seq_parallel) and self.m > 1

    @property
    def on(self) -> bool:
        """More than one rank on 'model': the tensor-parallel paths."""
        return self.m > 1

    def w(self, p) -> torch.Tensor:
        """A parameter as the block uses it: its local shard, gathered
        whole over every batch axis that shards it (FSDP)."""
        x = local(p)
        if self.mesh is None or not self.data_axes:
            return x
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(p, DTensor):
            return x
        for mdim, pl in enumerate(p.placements):
            if isinstance(pl, Shard) and mdim in self.data_axes:
                x = gather_to(x, pl.dim, self.data_axes[mdim])
        return x

    def norm_w(self, p, sp: bool) -> torch.Tensor:
        """A norm's scale (replicated over 'model'): sequence-parallel,
        each rank applies it to its own rows, so its gradient is summed
        over the ranks."""
        x = self.w(p)
        return copy_to(x, self.group) if sp else x

    def sp(self, seq: int) -> bool:
        """The residual stream of ``seq`` positions is sequence-sharded."""
        return self.seq_parallel and seq % self.m == 0

    def enter(self, h: torch.Tensor, sp: bool) -> torch.Tensor:
        """A replicated (or, sequence-parallel, seq-sharded) input as a
        region of rank-local products takes it."""
        return gather_to(h, 1, self.group) if sp else copy_to(h, self.group)

    def leave(self, y: torch.Tensor, sp: bool) -> torch.Tensor:
        """A region's partial sums back to the residual layout."""
        return (reduce_scatter(y, 1, self.group) if sp
                else reduce_from(y, self.group))

    def cols(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` columns."""
        c = n // self.m
        return slice(self.rank * c, (self.rank + 1) * c)

    def batch_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place sum over every batch axis (no autograd)."""
        for g in self.data_axes.values():
            all_reduce_(x, g)
        return x


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def split_to(x, dim: int, group):
    """This rank's slice along ``dim`` of a replicated ``x``; the
    backward all-gathers the slices' gradients."""
    return x if _size(group) == 1 else _Split.apply(x, dim, group)


def distribute(tree, specs, mesh):
    """A tree of tensors (dicts and lists, the port's parameters, moments
    or cache) as DTensors laid out by ``specs`` (the same tree of
    ``specs.P``): every rank holds the whole tree and keeps its shards,
    with no communication (``src_data_rank=None``).  Where no mesh axis
    of more than one rank splits a leaf (a replicated leaf, any leaf of
    a (1, 1) mesh) the shard is the input tensor itself, so the DTensor
    shares its storage (an in-place update of it, the train step's,
    writes into the input) and a one-card mesh costs no copy; a split
    leaf's shard is a copy.  Leaves that are not tensors (the cache's
    ``pos``) stay as they are."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from .specs import placements
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, specs)]
    if not isinstance(tree, torch.Tensor):
        return tree
    pls = placements(specs, mesh)
    if all(not isinstance(p, Shard) or mesh.size(i) == 1
           for i, p in enumerate(pls)):
        return DTensor.from_local(tree.detach(), mesh, pls, run_check=False)
    return distribute_tensor(tree, mesh, pls, src_data_rank=None)


def seq_chunks(t):
    """Where a serving cache's (B, H, S, hd) sequence lies: (this rank's
    first position, its chunk length, the groups of the mesh axes that
    split it, outer first).  A tensor that is not a DTensor is whole."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return 0, t.shape[2], []
    mesh = t.device_mesh
    start, size, groups = 0, t.shape[2], []
    for mdim, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            n = mesh.size(mdim)
            step = -(-size // n)            # torch.chunk's split, nested
            r = mesh.get_local_rank(mdim)
            start += r * step
            size = max(0, min(step, size - r * step))
            if n > 1:
                groups.append(mesh.get_group(mdim))
    return start, size, groups
