"""The plain reference of the sort cells, and the comparison that decides
``correct`` for them.

The guarantee a sort configuration states: the keys come out ascending,
every record comes out once and whole, and records with equal keys keep
their row-major input order (a stable sort of the t machines' rows laid
end to end).  The reference is that definition in plain PyTorch:
``torch.sort(stable=True)`` of the flattened keys and one gather of the
payload rows.  It works from the inputs the harness made, never from
anything the program derived.  Keys are compared as bits.

The keys must be finite and free of -0.0 and denormals (the generators
give such keys): the program folds those into ties, torch.sort does not.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["reference_sort", "compare_sort", "CONTROL_KEY_DTYPE"]

# The control's key precision: the nearest below float32 (bfloat16).
CONTROL_KEY_DTYPE = {torch.float32: torch.bfloat16}


def _bits(x: torch.Tensor) -> torch.Tensor:
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(width[x.element_size()])


def reference_sort(keys: torch.Tensor, payload: Optional[torch.Tensor],
                   compare_dtype: Optional[torch.dtype] = None):
    """The stable sort of (t, m) keys laid end to end, with their (t, m,
    cols) payload rows (or None).  ``compare_dtype`` sorts by the keys
    cast to that type instead (the control) and still returns the keys
    as they were given."""
    flat = keys.reshape(-1)
    by = flat if compare_dtype is None else flat.to(compare_dtype)
    order = torch.sort(by, stable=True).indices
    out_keys = flat[order]
    if payload is None:
        return out_keys, None
    return out_keys, payload.reshape(flat.shape[0], -1)[order]


def compare_sort(keys: torch.Tensor, payload: Optional[torch.Tensor],
                 out_keys: torch.Tensor, out_payload: Optional[torch.Tensor],
                 ) -> Dict[str, int]:
    """The numbers compared for one sort answer, each with the limit 0:

    * ``keys_wrong``: output positions whose key bits differ from the
      reference's, plus every position missing or extra;
    * ``rows_wrong``: output records whose payload row differs from the
      reference's (equal keys in another order show here: payload
      column 0 is the global row id), plus every row missing or extra.
    """
    ref_keys, ref_payload = reference_sort(keys, payload)
    out_keys = out_keys.reshape(-1)
    n = min(ref_keys.shape[0], out_keys.shape[0])
    gap = abs(ref_keys.shape[0] - out_keys.shape[0])
    keys_wrong = int((_bits(out_keys[:n]) != _bits(ref_keys[:n])).sum()) + gap
    numbers = {"keys_wrong": keys_wrong}
    if ref_payload is not None:
        if out_payload is None:
            numbers["rows_wrong"] = ref_payload.shape[0]
        else:
            out_rows = out_payload.reshape(out_payload.shape[0], -1)
            n = min(ref_payload.shape[0], out_rows.shape[0])
            gap = abs(ref_payload.shape[0] - out_rows.shape[0])
            numbers["rows_wrong"] = int(
                (out_rows[:n] != ref_payload[:n]).any(dim=1).sum()) + gap
    return numbers
