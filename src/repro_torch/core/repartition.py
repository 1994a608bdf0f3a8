"""Standard Repartition Join -- Hadoop's stock equi-join (paper §4 intro).

Counterpart of ``src/repro/core/repartition.py``.  Every tuple of a
join key lands on machine ``hash(key) % t``, which cross-products the
two sides.  It is the skew-vulnerable baseline: one hot key pins its
whole result to one machine, the imbalance the paper motivates with.
The hash runs on the host in numpy int64, as in the reference (an int32
product would overflow); the join runs on the device, batched over the
machines, with its one shuffle phase on the tape.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..cluster.substrate import default_pool
from .localjoin import MASKED_KEY, local_equijoin

__all__ = ["repartition_join"]


def _repartition_body(a, b, c, d, *, tape, out_capacity):
    with tape.phase("shuffle"):
        received = (a != MASKED_KEY).sum(1) + (c != MASKED_KEY).sum(1)
        tape.record(sent=received, received=received)
        return local_equijoin(a, b, c, d, out_capacity)


def _shard(keys: np.ndarray, rows: np.ndarray, t: int, device):
    """(n,) -> (t, cap) fragments: machine d holds, in input order, the
    tuples whose key hashes to d; MASKED_KEY and 0 pad."""
    dest = (keys * 2654435761 % 2**31) % t      # Knuth multiplicative hash
    per_machine = np.bincount(dest, minlength=t)
    cap = max(1, int(per_machine.max()))
    order = np.argsort(dest, kind="stable")
    col = np.arange(len(keys)) - np.repeat(np.cumsum(per_machine)
                                           - per_machine, per_machine)
    k = np.full((t, cap), MASKED_KEY, np.int32)
    v = np.zeros((t, cap), np.int32)
    k[dest[order], col] = keys[order]
    v[dest[order], col] = rows[order]
    return torch.from_numpy(k).to(device), torch.from_numpy(v).to(device)


def repartition_join(s_keys: np.ndarray, s_rows: np.ndarray,
                     t_keys: np.ndarray, t_rows: np.ndarray,
                     t_machines: int, out_capacity: int, device="cuda"):
    """Hash-partition both tables by key; join per machine on ``device``.

    Returns (JoinOutput, report).
    """
    t = t_machines
    s_keys = np.asarray(s_keys, np.int64)
    t_keys = np.asarray(t_keys, np.int64)
    sk, sr = _shard(s_keys, np.asarray(s_rows), t, device)
    tk, tr = _shard(t_keys, np.asarray(t_rows), t, device)
    body = functools.partial(_repartition_body, out_capacity=out_capacity)
    out, tape = default_pool()(t).run(body, sk, sr, tk, tr)
    counts = out.count.cpu().numpy()
    n_in = len(s_keys) + len(t_keys)
    report = tape.report(algorithm="RepartitionJoin", t=t, n_in=n_in,
                         n_out=int(counts.sum()), workload=counts)
    return out, report
