"""torch.distributed counterparts of the reference's mesh and collective
shims.

Counterpart of ``src/repro/cluster/compat.py``.  The reference funnels
the version-dependent jax surface (``shard_map``, ``make_mesh``,
``lax.ragged_all_to_all``) through one module; the port has no jax
versions to bridge, so what is left is the torch spelling of each:

* :func:`make_mesh` -- a ``DeviceMesh`` over the default group's ranks;
* :func:`ragged_all_to_all` -- ``dist.all_to_all_single`` with split
  sizes, the exchange whose every rank sends and receives its own
  counts;
* :func:`all_gather_rows` -- the gather of equal (rows, ...) blocks
  into (world * rows, ...), by ``dist.all_gather_single`` where torch
  has it (it deprecates ``all_gather_into_tensor`` there, warning on
  every call) and ``all_gather_into_tensor`` where it does not;
* :func:`axis_size` -- the number of ranks of a group.

Every function here is a collective: each rank of the group calls it,
in the same order as every other rank.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_gather_rows", "axis_size", "make_mesh", "ragged_all_to_all"]


def axis_size(group=None) -> int:
    """The number of ranks of ``group`` (None: the default group)."""
    return dist.get_world_size(group)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, in
    rank order, its dimensions named ``names``.  The product of
    ``shape`` must be the world size.  ``device_type`` None is the
    default group's: "cuda" under NCCL, "cpu" otherwise (Gloo, the dry
    run's fake group)."""
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        device_type = ("cuda" if "nccl" in str(dist.get_backend()).lower()
                       else "cpu")
    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size()
    if len(shape) != len(names) or int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"mesh {shape} named {tuple(names)} does not "
                         f"cover the {world} ranks of the default group")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(names))


def ragged_all_to_all(output: torch.Tensor, operand: torch.Tensor,
                      output_split_sizes: Sequence[int],
                      input_split_sizes: Sequence[int], *, group=None):
    """Rows ``[sum(input_split_sizes[:q]), ...)`` of ``operand`` go to
    rank q; the rows rank q sends land, in rank order, in ``output``.
    Each rank passes its own split sizes."""
    dist.all_to_all_single(output, operand,
                           output_split_sizes=list(output_split_sizes),
                           input_split_sizes=list(input_split_sizes),
                           group=group)
    return output


def all_gather_rows(output: torch.Tensor, operand: torch.Tensor, *,
                    group=None) -> torch.Tensor:
    """Rank r's (rows, ...) ``operand`` lands at rows [r*rows, (r+1)*rows)
    of every rank's ``output``."""
    gather: Optional[object] = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    gather(output, operand, group=group)
    return output
