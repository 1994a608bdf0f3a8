"""Production and host meshes, and the staged exchange's shard
factorization and its device mesh.

Counterpart of ``src/repro/launch/mesh.py`` (``STAGED_AXIS_NAMES`` :20,
``factor_shards`` :23, ``staged_axes`` :44, ``make_staged_mesh`` :54,
``make_production_mesh`` :68, ``make_host_mesh`` :83); the port imports
nothing of the reference package.  Every mesh is a ``DeviceMesh`` over
the default process group's ranks in rank order
(``cluster.compat.make_mesh``), which the caller initialises: a rank a
card (NCCL; ``torch.cuda.set_device`` first), Gloo ranks on the CPU, or
a fake group of 256 / 512 ranks in one process
(``launch/dryrun.py``).  The shard axis t is factored into t = t1 * t2 so
one t-way all-to-all becomes two ~sqrt(t)-way exchanges.  Only
balanced power-of-two factorizations are produced; anything else falls
back to the flat topology with a warning -- the staged path is an
optimization, not a requirement.  Machine g = i1 * t2 + i2 sits at
(i1, i2) of the (t1, t2) grid, on a batch (``BatchedSubstrate``) and
across the ranks of a process group (``ProcessGroupSubstrate``) alike;
:func:`make_staged_mesh` is the grid as a ``DeviceMesh`` of t ranks.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

__all__ = ["STAGED_AXIS_NAMES", "factor_shards", "staged_axes",
           "make_staged_mesh", "make_production_mesh", "make_host_mesh"]

STAGED_AXIS_NAMES = ("i1", "i2")


def factor_shards(t: int, *, warn: bool = False
                  ) -> Optional[Tuple[int, int]]:
    """Balanced two-level factorization t = t1 * t2 (t1 >= t2 >= 2).

    Returns ``None`` when no balanced power-of-two factorization exists
    (t < 4, or t not a power of two) -- the caller falls back to the flat
    exchange.  ``warn=True`` announces that fallback (user-facing call
    sites pass it; probing call sites like the planner stay silent).
    """
    t = int(t)
    if t < 4 or (t & (t - 1)) != 0:
        if warn:
            warnings.warn(
                f"t={t} has no balanced power-of-two factorization; "
                "falling back to the flat (single-stage) exchange",
                stacklevel=2)
        return None
    k = t.bit_length() - 1
    return (1 << (k - k // 2), 1 << (k // 2))



def staged_axes(t: int, names: Tuple[str, str] = STAGED_AXIS_NAMES,
                *, warn: bool = False):
    """Axis spec ``((name1, t1), (name2, t2))`` for a staged substrate,
    or ``None`` when t does not factor (see :func:`factor_shards`)."""
    fs = factor_shards(t, warn=warn)
    if fs is None:
        return None
    return ((names[0], fs[0]), (names[1], fs[1]))


def make_staged_mesh(t: int, names: Tuple[str, str] = STAGED_AXIS_NAMES,
                     device_type=None):
    """The (t1, t2) ``DeviceMesh`` of the staged exchange over the t
    ranks of the default group (``cluster.compat.make_mesh``).  A t
    that does not factor warns and gives a flat 1-axis mesh instead of
    raising -- the same contract as the exchange itself."""
    from ..cluster.compat import make_mesh

    fs = factor_shards(t, warn=True)
    if fs is None:
        return make_mesh((int(t),), (names[0],), device_type)
    return make_mesh(fs, names, device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 ranks per pod; multi_pod adds a 2-pod 'pod' axis.

    'pod'   -- pure data parallelism,
    'data'  -- batch + FSDP,
    'model' -- TP / EP / sequence-sharded KV.

    The default group must have 256 (512) ranks."""
    from ..cluster.compat import make_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(t: int = 8, device_type=None):
    """A small ('data', 'model') mesh over the default group's ranks (the
    reference counts ``jax.devices()``): min(t, world) ranks, half of
    them (at least one) on 'data'.  One card: a (1, 1) mesh."""
    import torch.distributed as dist

    from ..cluster.compat import make_mesh

    n = dist.get_world_size()
    t = min(t, n)
    data = max(1, t // 2) if t > 1 else 1
    model = t // data
    return make_mesh((data, model), ("data", "model"), device_type)
