"""The cluster front door of the port.

    from repro_torch import cluster
    (keys, values), report = cluster.sort(x, algorithm="smms", values=v)
    out, report = cluster.join(sk, sr, tk, tr, algorithm="statjoin",
                               t_machines=8)

Counterpart of ``src/repro/cluster/api.py`` (``sort`` :86, ``join``
:195): SMMS with the flat exchange, with or without values, and the
deterministic joins -- StatJoin (the paper's §4.3) and its baselines,
repartition and broadcast.  The other algorithms, topologies and the
planner are later slices of the port and raise ``NotImplementedError``
naming the ROADMAP item that brings them.

The run happens on the card unless the caller asks otherwise:
``device=None`` means ``"cuda"``, and raises when no card is present --
it never falls back to the CPU.  ``device="cpu"`` runs the kernels'
plain versions (what the tests do).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .capacity import CapacityPolicy, run_with_capacity

__all__ = ["sort", "join", "SORT_ALGORITHMS", "JOIN_ALGORITHMS",
           "resolve_device"]

SORT_ALGORITHMS = ("smms",)
JOIN_ALGORITHMS = ("statjoin", "repartition", "broadcast")


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

    x: a numpy array or a tensor; values: None, or (t, m, ...) payload
    aligned with x.  Returns ``((keys, values), report)``: the n sorted
    keys as a tensor on the run's device, the values in the keys'
    stable order (or None), and the AlphaKReport, as the reference's
    front door returns them.
    """
    if algorithm != "smms":
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not ported yet (Terasort is "
            f"ROADMAP queue A item 4); the port runs 'smms'")
    if exchange != "flat":
        raise NotImplementedError(
            f"exchange={exchange!r} is not ported yet (the staged exchange "
            f"is ROADMAP queue A item 6); the port runs 'flat'")
    if np.ndim(x) != 2:
        raise ValueError(
            f"sort expects x of shape (t, m) -- one row per machine -- got "
            f"shape {tuple(np.shape(x))}; reshape with x.reshape(t, -1)")
    if values is not None and tuple(np.shape(values)[:2]) != np.shape(x):
        raise ValueError(f"values of shape {tuple(np.shape(values))} do not "
                         f"align with x of shape {tuple(np.shape(x))}")
    dev = resolve_device(device)
    xt = torch.as_tensor(x).to(dev).contiguous()
    vt = None if values is None else torch.as_tensor(values).to(dev)
    from ..core.smms import smms_sort
    return smms_sort(xt, r=r, cap_factor=cap_factor, policy=policy,
                     values=vt)


def join(s_keys, s_rows, t_keys, t_rows, *, algorithm: str = "statjoin",
         t_machines: int, out_capacity: Optional[int] = None,
         out_cap_factor: float = 1.05, stats=None,
         small_side: Optional[str] = None, device=None):
    """Distributed equi-join of S and T.  Returns (JoinOutput, report).

    Keys and row ids are host arrays (int32 keys below MASKED_KEY);
    planning and routing run on the host in numpy, as in the reference,
    and the local joins on ``device``, all t machines at once.

    ``out_capacity`` defaults, from exact statistics (W result pairs),
    to W + 64 for repartition -- which can pin the whole result on one
    machine, the imbalance it exists to show -- and to
    max(64, ceil(2 out_cap_factor W / t)) for broadcast, which retries
    with doubled capacity up to three times when results drop.
    StatJoin sizes its own by Theorem 6.
    """
    if algorithm == "randjoin":
        raise NotImplementedError(
            "algorithm='randjoin' is not ported yet (ROADMAP queue A item 5 "
            "with trap C3: its routing draws from jax.random)")
    if algorithm == "auto":
        raise NotImplementedError(
            "algorithm='auto' is not ported yet (the planner is ROADMAP "
            "queue A item 9)")
    if algorithm not in JOIN_ALGORITHMS:
        raise ValueError(f"unknown join algorithm {algorithm!r}; "
                         f"expected one of {JOIN_ALGORITHMS}")
    dev = resolve_device(device)
    if algorithm == "statjoin":
        from ..core.statjoin import statjoin
        return statjoin(s_keys, s_rows, t_keys, t_rows, t_machines,
                        out_cap_factor=out_cap_factor, stats=stats,
                        out_capacity=out_capacity, device=dev)

    defaulted_capacity = out_capacity is None
    if defaulted_capacity:
        from ..core.statjoin import collect_statistics
        st = stats if stats is not None else collect_statistics(
            np.asarray(s_keys, np.int64), np.asarray(t_keys, np.int64))
        w = st.total
        if algorithm == "repartition":
            out_capacity = w + 64
        else:
            out_capacity = max(64, int(np.ceil(2.0 * out_cap_factor * w
                                               / t_machines)))
    if algorithm == "repartition":
        from ..core.repartition import repartition_join
        return repartition_join(s_keys, s_rows, t_keys, t_rows, t_machines,
                                out_capacity, device=dev)

    from ..core.broadcastjoin import broadcast_join

    def attempt(cap):
        out, rep = broadcast_join(s_keys, s_rows, t_keys, t_rows, t_machines,
                                  int(cap), small_side=small_side,
                                  device=dev)
        return (out, rep), int(out.dropped.max())

    if not defaulted_capacity:
        return attempt(out_capacity)[0]
    (out, rep), factor, attempts = run_with_capacity(
        attempt, CapacityPolicy.fixed(out_capacity, max_retries=3))
    rep.cap_factor = factor
    rep.capacity_attempts = attempts
    return out, rep
