"""The plain reference of the join cells, and the comparison that decides
``correct`` for them.

The guarantee a join configuration states: the equi-join is exact, so
every pair (i, j) with S[i] = T[j] comes out once, and nothing else does.
Rows are named by their row ids, which the harness makes as
``arange(n)`` for both tables; a pair is coded as the int64
``s_row * |T| + t_row``.  :func:`reference_pairs` lists the join's codes
in ascending order in plain numpy, from the key columns alone.

:func:`capped_repartition_pairs` is the control: the textbook
repartition join (each key hashed to one of t machines) given the same
per-machine output capacity as Theorem 6 gives StatJoin, which drops the
pairs a hot key piles onto one machine past it.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

__all__ = ["reference_pairs", "compare_join", "capped_repartition_pairs",
           "output_capacity"]


def reference_pairs(s_keys: np.ndarray, t_keys: np.ndarray) -> np.ndarray:
    """Every pair of the equi-join as ascending int64 codes
    ``i * len(t_keys) + j``."""
    s_keys = np.asarray(s_keys)
    t_keys = np.asarray(t_keys)
    n_t = len(t_keys)
    t_order = np.argsort(t_keys, kind="stable")     # j ascending in a key
    t_sorted = t_keys[t_order]
    lo = np.searchsorted(t_sorted, s_keys, side="left")
    hi = np.searchsorted(t_sorted, s_keys, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    # row i's partners are t_order[lo[i]:hi[i]], emitted for i ascending
    first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    j = t_order[first + np.arange(total)]
    i = np.repeat(np.arange(len(s_keys), dtype=np.int64), cnt)
    return i * n_t + j


def output_capacity(w: int, t: int, factor: float = 1.05) -> int:
    """Theorem 6's output slots a machine, ceil(factor * 2W / t)."""
    return max(1, math.ceil(factor * 2.0 * w / t))


def capped_repartition_pairs(s_keys: np.ndarray, t_keys: np.ndarray,
                             t: int) -> np.ndarray:
    """The control: key k's pairs go to machine k mod t, each machine
    keeps its first :func:`output_capacity` pairs (in code order) and
    drops the rest.  Returns the kept codes, ascending."""
    codes = reference_pairs(s_keys, t_keys)
    if codes.size == 0:
        return codes
    n_t = len(t_keys)
    machine = np.asarray(s_keys, np.int64)[codes // n_t] % t
    order = np.argsort(machine, kind="stable")
    per = np.bincount(machine, minlength=t)
    rank = np.arange(codes.size) - np.repeat(np.cumsum(per) - per, per)
    keep = order[rank < output_capacity(codes.size, t)]
    return np.sort(codes[keep])


def compare_join(s_keys: np.ndarray, t_keys: np.ndarray,
                 s_rows: torch.Tensor, t_rows: torch.Tensor,
                 valid: torch.Tensor) -> Dict[str, int]:
    """The numbers compared for one join answer, each with the limit 0:

    * ``pairs_missing``: pairs of the join that the answer lacks;
    * ``pairs_wrong``: distinct pairs in the answer that are not in the
      join (a wrong row id, a pair of unequal keys);
    * ``pairs_repeated``: pairs the answer holds more than once.

    ``s_rows`` / ``t_rows`` / ``valid``: the answer's row-id slots and
    their mask, any shape, on any device (the check runs there).
    """
    dev = s_rows.device
    ref = torch.from_numpy(reference_pairs(s_keys, t_keys)).to(dev)
    n_t = len(t_keys)
    got = (s_rows[valid].long() * n_t + t_rows[valid].long())
    got = torch.sort(got).values
    uniq = torch.unique_consecutive(got)
    repeated = int(got.shape[0] - uniq.shape[0])
    if ref.numel() == 0:
        found = 0
    else:
        at = torch.searchsorted(ref, uniq).clamp_(max=ref.shape[0] - 1)
        found = int((ref[at] == uniq).sum())
    return {"pairs_missing": int(ref.shape[0]) - found,
            "pairs_wrong": int(uniq.shape[0]) - found,
            "pairs_repeated": repeated}
