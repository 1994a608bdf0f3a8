"""Where the port's entry points run: the one rule every front door,
planner, model and pipeline resolves its ``device=`` argument by.

A leaf module (it imports only torch), so the lower layers need not
import the cluster front door that sits above them."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run the plain "
                           "versions of the kernels on the CPU")
    return dev
