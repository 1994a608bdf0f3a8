"""The cluster front door of the port.

    from repro_torch import cluster
    (keys, _), report = cluster.sort(x, algorithm="smms")

Counterpart of ``src/repro/cluster/api.py`` (``sort`` :86), for the
keys-only SMMS path with the flat exchange.  The other algorithms,
topologies and payloads of the reference are later slices of the port
and raise ``NotImplementedError`` naming the ROADMAP item that brings
them.

The run happens on the card unless the caller asks otherwise:
``device=None`` means ``"cuda"``, and raises when no card is present --
it never falls back to the CPU.  ``device="cpu"`` runs the kernels'
plain versions (what the tests do).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["sort", "SORT_ALGORITHMS", "resolve_device"]

SORT_ALGORITHMS = ("smms",)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run the plain "
                           "versions of the kernels on the CPU")
    return dev


def sort(x, *, algorithm: str = "smms", r: int = 2,
         cap_factor: Optional[float] = None, policy=None, values=None,
         exchange: str = "flat", device=None):
    """Distributed sort of x: (t, m), one row per machine.

    x: a numpy array or a tensor.  Returns ``((keys, None), report)``:
    the n sorted keys as a tensor on the run's device and the
    AlphaKReport, as the reference's front door returns them.
    """
    if algorithm != "smms":
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not ported yet (Terasort is "
            f"ROADMAP queue A item 4); the port runs 'smms'")
    if exchange != "flat":
        raise NotImplementedError(
            f"exchange={exchange!r} is not ported yet (the staged exchange "
            f"is ROADMAP queue A item 6); the port runs 'flat'")
    if values is not None:
        raise NotImplementedError(
            "values= is not ported yet (SMMS with values, with the "
            "bitonic_sort_kv and argsort-merge kernels, is the next slice: "
            "ROADMAP queue A item 3 and queue B items 2 and 4)")
    if np.ndim(x) != 2:
        raise ValueError(
            f"sort expects x of shape (t, m) -- one row per machine -- got "
            f"shape {tuple(np.shape(x))}; reshape with x.reshape(t, -1)")
    dev = resolve_device(device)
    xt = torch.as_tensor(x).to(dev).contiguous()
    from ..core.smms import smms_sort
    return smms_sort(xt, r=r, cap_factor=cap_factor, policy=policy)
