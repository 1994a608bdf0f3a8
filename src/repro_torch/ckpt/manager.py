"""Fault-tolerant checkpointing: atomic step directories.

Counterpart of ``src/repro/ckpt/manager.py``, with its on-disk format:

* every save writes ``step_<N>.tmp/`` and renames it to ``step_<N>/``
  atomically, so a crash mid-save never corrupts the latest checkpoint;
* the leaves go into one ``leaves.npz`` (``leaf_<i>`` in JAX's leaf
  order: dict keys sorted) beside a ``manifest.json`` (step, leaf
  paths as the reference names them, shapes, dtypes);
* ``keep`` bounds the checkpoints on disk; ``latest_step`` lets
  ``launch/train.py`` resume after a preemption.

A tree here is the port's: dicts (keys in insertion order) and lists of
tensors, Python numbers or numpy arrays.  A bfloat16 leaf is saved
through float32, which holds it exactly, and its manifest dtype stays
``bfloat16``.  :meth:`CheckpointManager.restore` fills the structure of
``like``, each leaf in ``like``'s dtype on ``device`` (None: the
device of ``like``'s leaf).

On a mesh (DTensor leaves) a save is a collective: every rank gathers
each leaf whole (``full_tensor``), rank 0 writes, and the ranks meet at
a barrier before any returns.  A restore reads the whole leaves on every
rank and lays each out as ``like``'s leaf is -- on the run's own mesh,
whatever mesh saved it (the reference's elastic re-scale,
``src/repro/ckpt/manager.py:88``), or whole where ``like`` is.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's leaf order (dict keys sorted) with its
    path names ("a/b", a list index "[0]")."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{prefix}[{i}]/")]
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator in
    :func:`_flatten`'s order."""
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to save, its dtype's name); a DTensor gathered whole
    (a collective)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    a = np.asarray(leaf)
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        pairs = _flatten(tree)
        final = self._path(step)
        if any(_is_dtensor(leaf) for _, leaf in pairs):
            import torch.distributed as dist
            whole = [(p, _to_numpy(leaf)) for p, leaf in pairs]
            if dist.get_rank() == 0:
                self._write(step, whole)
            dist.barrier()
            return final
        return self._write(step, [(p, _to_numpy(leaf)) for p, leaf in pairs])

    def _write(self, step: int, pairs) -> str:
        tmp, final = self._path(step) + ".tmp", self._path(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays, dtypes = {}, []
        for i, (_, (array, name)) in enumerate(pairs):
            arrays[f"leaf_{i}"] = array
            dtypes.append(name)
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        manifest = {"step": step, "paths": [p for p, _ in pairs],
                    "shapes": [list(a.shape) for a in arrays.values()],
                    "dtypes": dtypes}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if not os.path.exists(final):
            os.replace(tmp, final)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Any, device=None) -> Any:
        """The checkpoint of ``step`` in the structure of ``like``: each
        leaf a tensor of ``like``'s leaf's dtype on ``device`` (None:
        that leaf's device), a DTensor laid out as ``like``'s where that
        is one.  Raises ``ValueError`` where the leaf count or a shape
        differs."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        want = [leaf for _, leaf in _flatten(like)]
        if len(manifest["paths"]) != len(want):
            raise ValueError(f"checkpoint has {len(manifest['paths'])} "
                             f"leaves, expected {len(want)}")
        out = []
        with np.load(os.path.join(path, "leaves.npz")) as data:
            for i, ref in enumerate(want):
                got = data[f"leaf_{i}"]
                if tuple(got.shape) != tuple(np.shape(ref)):
                    raise ValueError(
                        f"leaf {manifest['paths'][i]}: checkpoint shape "
                        f"{tuple(got.shape)}, expected {tuple(np.shape(ref))}")
                t = torch.from_numpy(got)
                if _is_dtensor(ref):
                    from torch.distributed.tensor import distribute_tensor
                    t = distribute_tensor(
                        t.to(device=ref.device if device is None else device,
                             dtype=ref.dtype),
                        ref.device_mesh, ref.placements, src_data_rank=None)
                elif isinstance(ref, torch.Tensor):
                    t = t.to(device=ref.device if device is None else device,
                             dtype=ref.dtype)
                elif device is not None:
                    t = t.to(device)
                out.append(t)
        return _unflatten(like, iter(out))
