"""Partition rules: parameters (TP + optional FSDP + EP) and activations.

Counterpart of ``src/repro/sharding/specs.py``, with its names and its
decisions.  Mesh axes: ``('data', 'model')`` single-pod, ``('pod',
'data', 'model')`` multi-pod.  The ``pod`` axis is pure data
parallelism; ``model`` carries TP / EP; ``data`` carries the batch and
FSDP for the big architectures (above ``fsdp_threshold`` parameters).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``, or anything
with ``.shape`` and ``.axis_names`` (a ``DeviceMesh``'s
``mesh_dim_names`` serve), so the rules can be built for a mesh no
process holds (the tests' stand-ins, the dry run's fake group).  A spec
is a :class:`P`: a tuple with one entry a tensor dimension, each an
axis name, a tuple of names (major to minor) or None.

The reference constrains arrays inside its jitted program
(``with_sharding_constraint``); the port runs eagerly on each rank's
local shards (``sharding/parallel.py``), so here ``hidden`` / ``heads``
/ ``ffn`` / ``moe_slots`` / ``group_major`` return the tensor they are
given (a DTensor is redistributed to the spec), and the layout each
decides is read from its ``*_spec`` twin, which the model uses to pick
its local layout.  :func:`placements` turns a spec into DTensor
placements.  With ``mesh=None`` every method is the identity, as the
reference's is.

Period-stacked parameters: the reference stacks a period's leaves on a
leading ``n_periods`` axis (spec entry None); the port keeps one dict a
period, so :meth:`ShardingRules.param_specs` and :meth:`cache_specs`
give the port's leaves the reference's spec without that entry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..configs.base import ArchConfig

__all__ = ["ShardingRules", "make_rules", "P", "placements", "axis_sizes",
           "local_shape"]


class P(tuple):
    """A PartitionSpec: one entry a tensor dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (a DeviceMesh or a stand-in)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(_axis_names(mesh), (int(s) for s in shape)))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dimension that entry i names, ``Replicate()`` elsewhere.  Where
    one entry names several axes, DTensor splits the dimension in
    mesh-dimension order, the outer first; the spec's major-to-minor
    order must be that order (it is for every spec of the rules:
    ``batch_axes + (model,)``), else a ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} splits dim {dim} in an "
                             f"order other than the mesh's {names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of the largest local shard of a ``shape`` tensor laid
    out by ``spec``: each dimension divided, rounding up, by the product
    of the axes its entry names (rank 0's shard)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        parts = 1
        if dim < len(spec):
            for a in _entry_axes(spec[dim]):
                parts *= sizes[a]
        out.append(-(-int(n) // parts))
    return tuple(out)


@dataclasses.dataclass
class ShardingRules:
    mesh: Optional[object]
    batch_axes: Tuple[str, ...]         # ('pod','data') or ('data',)
    model_axis: str = "model"
    fsdp: bool = False                  # shard the non-TP weight dim on data
    fsdp_axis: str = "data"
    seq_parallel: bool = False          # residual stream seq-sharded over
    #                                     'model' between TP regions

    # ------------------------------------------------------------------
    def _axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return axis_sizes(self.mesh)[name]

    def _div(self, dim: int, *axes: Optional[str]):
        """First axis (or tuple) that evenly divides dim, else None."""
        total = 1
        for a in axes:
            if a is None:
                return None
            total *= self._axis_size(a)
        if dim % total == 0:
            return axes[0] if len(axes) == 1 else axes
        return None

    def constrain(self, x, spec: P):
        """A DTensor redistributed to ``spec``; anything else as it is
        (the reference's ``with_sharding_constraint``)."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x.redistribute(x.device_mesh, placements(spec, self.mesh))
        return x

    # ---- parameter specs ----------------------------------------------
    def param_spec(self, path: str, ndim: int, cfg: ArchConfig) -> P:
        """Spec by parameter name, the reference's: a path under
        ``periods/`` is period-stacked, its leading dim mapped to None
        (``ndim`` counts it)."""
        mdl = self.model_axis
        fsdp = self.fsdp_axis if self.fsdp else None
        name = path.split("/")[-1]
        stacked = "/periods/" in f"/{path}"
        ep_ok = (cfg.moe is not None
                 and cfg.moe.num_experts % max(1, self._axis_size(mdl)) == 0)

        def wrap(spec: P) -> P:
            if stacked:
                return P(*((None,) + tuple(spec)))
            return spec

        if name == "embed":
            return wrap(P(mdl, fsdp))
        if name == "unembed":
            return wrap(P(fsdp, mdl))
        if name == "frontend_proj":
            return wrap(P(None, mdl))
        if name in ("wq", "wk", "wv"):
            return wrap(P(fsdp, mdl))
        if name == "wo":
            return wrap(P(mdl, fsdp))
        if name in ("w_gate", "w_up"):
            if ndim - (1 if stacked else 0) == 3:  # MoE experts (E, d, ff)
                return wrap(P(mdl, fsdp, None) if ep_ok
                            else P(None, fsdp, mdl))
            return wrap(P(fsdp, mdl))
        if name == "w_down":
            if ndim - (1 if stacked else 0) == 3:  # (E, ff, d)
                return wrap(P(mdl, None, fsdp) if ep_ok
                            else P(None, mdl, fsdp))
            return wrap(P(mdl, fsdp))
        if name == "router":
            return wrap(P(fsdp, None))
        if name == "in_proj":
            return wrap(P(fsdp, mdl))
        if name == "out_proj":
            return wrap(P(mdl, fsdp))
        if name == "conv_w":
            return wrap(P(None, mdl))
        # norms, biases, A_log, D, dt_bias, conv_b, scalars: replicated
        return wrap(P(*([None] * max(0, ndim - (1 if stacked else 0)))))

    def param_specs(self, params_shape) -> dict:
        """The port's parameter tree (tensors, on any device) mapped to
        specs, each leaf under ``periods`` given the reference's
        stacked spec without its leading entry."""
        cfg = getattr(self, "_cfg", None)

        def visit(tree, path, stacked):
            if isinstance(tree, dict):
                return {k: visit(v, f"{path}{k}/", stacked)
                        for k, v in tree.items()}
            if isinstance(tree, list):   # periods: one dict a period
                return [visit(v, path, True) for v in tree]
            spec = self.param_spec(path[:-1], len(tree.shape)
                                   + (1 if stacked else 0), cfg)
            return P(*spec[1:]) if stacked else spec

        return visit(params_shape, "", False)

    def bind(self, cfg: ArchConfig) -> "ShardingRules":
        self._cfg = cfg
        return self

    # ---- activation layouts ---------------------------------------------
    def _batch_entry(self, b: int):
        return self._div(b, *self.batch_axes) or self._div(
            b, self.batch_axes[-1])

    def hidden_spec(self, shape) -> P:
        """(B, S, d): batch over batch_axes (when divisible); with
        seq_parallel, the sequence also over 'model'."""
        b, s = shape[0], shape[1]
        ax = self._div(b, *self.batch_axes)
        if ax is None and len(self.batch_axes) > 1:
            ax = self._div(b, self.batch_axes[-1])
        if self.seq_parallel and s % max(1, self._axis_size(
                self.model_axis)) == 0:
            return P(ax, self.model_axis, None)
        return P(ax, None, None)

    def heads_spec(self, shape) -> P:
        """(B, S, H, hd): heads on model when divisible, else seq."""
        b, s, h, _ = shape
        bax = self._batch_entry(b)
        if h % max(1, self._axis_size(self.model_axis)) == 0:
            return P(bax, None, self.model_axis, None)
        if s % max(1, self._axis_size(self.model_axis)) == 0:
            return P(bax, self.model_axis, None, None)
        return P(bax, None, None, None)

    def ffn_spec(self, shape) -> P:
        """(B, S, ff): ff on model."""
        return P(self._batch_entry(shape[0]), None, self.model_axis)

    def _batch_sp(self):
        return (self.batch_axes if len(self.batch_axes) > 1
                else self.batch_axes[0])

    def moe_slots_spec(self, ndim: int) -> P:
        """Slot-major dispatch buffer: slots over model.  Rank 4 = (NS,
        G, C, d) with groups over the batch axes; rank 3 = (NS, C, d)."""
        if ndim == 4:
            return P(self.model_axis, self._batch_sp(), None, None)
        return P(self.model_axis, None, None)

    def group_major_spec(self, ndim: int) -> P:
        """(G, ...) buffers: G over the batch axes, rest unsharded."""
        return P(self._batch_sp(), *([None] * (ndim - 1)))

    def hidden(self, x):
        return self.constrain(x, self.hidden_spec(x.shape))

    def heads(self, x):
        return self.constrain(x, self.heads_spec(x.shape))

    def ffn(self, x):
        return self.constrain(x, self.ffn_spec(x.shape))

    def moe_slots(self, buf):
        return self.constrain(buf, self.moe_slots_spec(buf.dim()))

    def group_major(self, x):
        return self.constrain(x, self.group_major_spec(x.dim()))

    def moe_groups(self) -> int:
        """Dispatch-group count = number of data shards (group-local
        scatter stays collective-free; see models/moe.py)."""
        return self._total_batch() if self.mesh is not None else 1

    # ---- serving cache ---------------------------------------------------
    def cache_specs(self, cache_shape) -> dict:
        """Specs for the port's serving cache (by leaf name): k/v and
        their scales (B, Hkv, S, hd|1) -- batch over batch_axes and the
        sequence over 'model' when the batch divides, else the sequence
        over every axis; conv (B, W-1, cd) -- channels over model; ssm
        (B, H, P, N) -- heads over model; ``pos`` replicated."""
        total_b = self._total_batch()
        mdl = self.model_axis
        batch_sp = self._batch_sp()

        def leaf(name, shape):
            b = shape[0] if len(shape) > 0 else 1
            b_ok = b % max(1, total_b) == 0
            if name in ("k", "v", "k_scale", "v_scale"):
                if b_ok:
                    return P(batch_sp, None, mdl, None)
                return P(None, None, tuple(self.batch_axes) + (mdl,), None)
            if name == "conv":
                return P(batch_sp if b_ok else None, None, mdl)
            if name == "ssm":
                return P(batch_sp if b_ok else None, mdl, None, None)
            return P()

        def visit(tree, name):
            if isinstance(tree, dict):
                return {k: visit(v, k) for k, v in tree.items()}
            if isinstance(tree, list):
                return [visit(v, name) for v in tree]
            return leaf(name, tuple(getattr(tree, "shape", ())))

        return visit(cache_shape, "")

    def kv_cache_spec(self, batch: int, seq: int) -> P:
        """(n_periods, B, Hkv, S_max, hd) cache layout per shape (the
        reference's stacked form)."""
        if batch % max(1, self._total_batch()) == 0:
            return P(None, self._batch_sp(), None, self.model_axis, None)
        # tiny batch (long-context): shard the sequence over everything
        axes = tuple(self.batch_axes) + (self.model_axis,)
        return P(None, None, None, axes, None)

    def _total_batch(self) -> int:
        t = 1
        for a in self.batch_axes:
            t *= self._axis_size(a)
        return t

    def batch_spec(self, batch: int) -> P:
        return P(self._batch_entry(batch), None)


def make_rules(mesh, cfg: ArchConfig,
               fsdp_threshold: int = 10_000_000_000, *,
               seq_parallel: bool = False) -> ShardingRules:
    """FSDP kicks in automatically above ~10B params.  ``seq_parallel``
    shards the residual stream's sequence over 'model' between blocks
    (the reference sets the field after building the rules)."""
    if mesh is None:
        return ShardingRules(None, ("data",)).bind(cfg)
    axes = _axis_names(mesh)
    batch_axes = tuple(a for a in axes if a != "model")
    fsdp = cfg.param_count() > fsdp_threshold
    return ShardingRules(mesh, batch_axes, fsdp=fsdp,
                         seq_parallel=seq_parallel).bind(cfg)
