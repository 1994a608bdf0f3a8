"""SMMS -- Sort-Map-Merge Sort (paper §3.1), on one card.

Counterpart of ``src/repro/core/smms.py`` (``smms_shard`` :111,
``smms_sort`` :201).  Three rounds, written batched over the t machines:

  Round 1   local sort (the bitonic kernel; with values the (key, iota)
            pair-sort kernel and one gather of the values) and
            s+1 = r*t+1 equi-depth samples per machine, all-gathered.
  Round 2   Algorithm 1 on the gathered samples (every machine would
            compute the same boundaries; the port computes them once).
  Round 3   cut each sorted row at the boundaries (the searchsorted
            kernel), pack the (t, C) tiles sized by Theorem 1, exchange
            them all-to-all and merge the landed sorted rows (the
            bitonic merge kernel, or the rank-merge kernel past one
            tile; with values their argsort variants).

The capacity-retry loop re-runs the body with a doubled factor while
objects drop; it reads the dropped count back to the host once per
attempt.  Guarantee (Thm 2): (3, 1 + 2/r + r t^3/n)-minimal for t^3 <= n.

``exchange="staged"`` runs Round 3 as the two-level staged exchange
over the (t1, t2) factorization of t (``resolve_exchange_topology``):
the samples are gathered in two hops and the shuffle splits into the
phases "round3 shuffle s1" and "s2", so alpha is 4; the keys are the
flat path's, bitwise.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..cluster.capacity import CapacityPolicy, run_with_capacity
from ..cluster.collectives import CollectiveTape
from ..cluster.substrate import BatchedSubstrate, resolve_substrate
from ..kernels import ops
from .alpha_k import smms_workload_bound
from .boundaries import boundaries, equidepth_samples
from .exchange import exchange_sorted_segments

__all__ = ["smms_shard", "smms_sort", "SortResult", "default_cap_factor",
           "received_objects", "resolve_exchange_topology"]


def resolve_exchange_topology(substrate, t: int, exchange: str = "flat"):
    """Resolve ``(substrate, staged_shape)`` for a t-machine sort.

    The reference's ``resolve_exchange_topology``
    (``src/repro/core/smms.py:43``).  ``substrate`` is what the front
    door takes (a substrate, a provider such as a ``SubstratePool``, or
    None, the process-wide pool):

    * a 2-axis substrate always runs staged over its own (t1, t2) shape;
    * ``exchange="staged"`` with a provider (or None) resolves a 2-axis
      substrate over the balanced factorization of t -- a t without one
      warns and runs flat;
    * ``exchange="staged"`` with an explicit 1-axis substrate warns and
      stays flat.

    ``staged_shape=None`` in the result means the flat exchange.
    """
    import warnings

    from ..launch.mesh import STAGED_AXIS_NAMES, factor_shards

    if exchange not in ("flat", "staged"):
        raise ValueError(f"unknown exchange topology {exchange!r}; "
                         "expected 'flat' or 'staged'")
    explicit = isinstance(substrate, BatchedSubstrate)
    if explicit and len(substrate.axes) == 2:
        t1, t2 = substrate.shape
        if min(t1, t2) < 2:
            raise ValueError(f"2-axis substrate {substrate.shape} cannot "
                             "stage the exchange: both sub-axes must be "
                             ">= 2")
        return substrate, (t1, t2)
    if exchange == "staged":
        if explicit:
            warnings.warn(
                "explicit single-axis substrate cannot run the staged "
                "exchange; falling back to the flat topology",
                stacklevel=2)
            return substrate, None
        fs = factor_shards(t, warn=True)
        if fs is None:
            return resolve_substrate(substrate, t), None
        return resolve_substrate(substrate, (STAGED_AXIS_NAMES[0], fs[0]),
                                 (STAGED_AXIS_NAMES[1], fs[1])), fs
    return resolve_substrate(substrate, t), None


class SortResult(NamedTuple):
    keys: torch.Tensor        # (t, C) per machine; ascending, PAD-filled tail
    values: Optional[torch.Tensor]
    count: torch.Tensor       # (t,) valid keys on each machine
    sent: torch.Tensor        # (t,) keys each machine shipped in Round 3
    dropped: torch.Tensor     # global overflow count (0 == success)
    boundaries: torch.Tensor  # (t+1,) the Algorithm-1 boundaries


def received_objects(res: SortResult):
    """The sort's output: every machine's valid keys, machine 0's first,
    and their values (or None)."""
    valid = (torch.arange(res.keys.shape[1], device=res.keys.device)[None, :]
             < res.count[:, None].long())
    return res.keys[valid], None if res.values is None else res.values[valid]


def default_cap_factor(n: int, t: int, r: int, slack: float = 1.05) -> float:
    """Static receive capacity from Theorem 1, with a small safety slack."""
    return CapacityPolicy.smms(n, t, r, slack=slack).first_factor


def smms_shard(x: torch.Tensor, *, t: int, r: int = 2,
               cap_factor: Optional[float] = None,
               values: Optional[torch.Tensor] = None,
               staged_shape: Optional[tuple] = None,
               overlap_chunks: int = 2,
               tape: Optional[CollectiveTape] = None) -> SortResult:
    """The SMMS body for all t machines.  x: (t, m), row i machine i's
    keys; values: (t, m, ...) their payload, or None.
    ``staged_shape=(t1, t2)`` runs Round 3 as the staged exchange."""
    m = x.shape[1]
    n = m * t
    s = r * t
    if cap_factor is None:
        cap_factor = default_cap_factor(n, t, r)
    if tape is None:
        tape = CollectiveTape()

    # Round 1: pad once, sort the padded rows, sample the m real keys.
    with tape.phase("round1->2 samples"):
        if values is not None:
            xs, values = ops.sort_kv(ops.pad_pow2(x),
                                     ops.pad_pow2(values, fill=0, axis=1),
                                     prepadded=True)
        else:
            xs = ops.sort(ops.pad_pow2(x), prepadded=True)  # (t, np2)
        lam = equidepth_samples(xs[:, :m], s)               # (t, s+1)
        if staged_shape is not None:
            lam_all = tape.all_gather_multi(lam, grid=staged_shape)
        else:
            lam_all = tape.all_gather(lam)                  # (t, s+1)

    # Round 2: Algorithm 1 (no traffic, still a round).
    with tape.phase("round2 boundaries"):
        b = boundaries(lam_all, m, s)                       # (t+1,)

    # Round 3: cut, exchange, merge.  The staged exchange declares its
    # own phases ("round3 shuffle s1"/"s2"): no outer phase.
    if staged_shape is not None:
        ex = exchange_sorted_segments(
            xs, b[1:-1], t=t, cap_factor=cap_factor, values=values,
            valid_len=m, tape=tape, staged_shape=staged_shape,
            overlap_chunks=overlap_chunks, phase_prefix="round3 shuffle")
    else:
        with tape.phase("round3 shuffle"):
            ex = exchange_sorted_segments(
                xs, b[1:-1], t=t, cap_factor=cap_factor, values=values,
                valid_len=m, tape=tape)
    return SortResult(ex.keys, ex.values, ex.count, ex.sent, ex.dropped, b)


def smms_sort(x: torch.Tensor, r: int = 2, cap_factor: Optional[float] = None,
              policy: Optional[CapacityPolicy] = None,
              values: Optional[torch.Tensor] = None,
              exchange: str = "flat", overlap_chunks: int = 2,
              substrate=None):
    """Sort x of shape (t, m) across t machines, on x's device.

    Returns ``((sorted_keys, sorted_values), report)``: the n sorted
    keys as a tensor on x's device, machine 0's first, with ``values``
    ((t, m, ...) or None) in the keys' stable order beside them, and
    the AlphaKReport with
    ``exchange_topology``, ``theoretical_workload_bound``, ``cap_factor``
    and ``capacity_attempts``.  An explicit ``cap_factor`` pins the
    capacity (no retry); otherwise Theorem 1 sizes it and the policy
    retries on overflow.  ``exchange="staged"`` runs Round 3 over the
    (t1, t2) factorization of t, its stage 2 in ``overlap_chunks``
    slices (a t that does not factor warns and runs flat);
    ``report.exchange_topology`` says which ran.  ``substrate`` as
    :func:`resolve_exchange_topology` takes it.
    """
    t, m = x.shape
    n = t * m
    substrate, staged_shape = resolve_exchange_topology(substrate, t,
                                                        exchange)
    if substrate.t != t:
        raise ValueError(f"{substrate!r} runs {substrate.t} machines; "
                         f"x has {t} rows")
    if policy is None:
        policy = (CapacityPolicy.fixed(cap_factor) if cap_factor is not None
                  else CapacityPolicy.smms(n, t, r))

    def attempt(factor):
        res, tape = substrate.run(
            functools.partial(smms_shard, t=t, r=r, cap_factor=float(factor),
                              values=values, staged_shape=staged_shape,
                              overlap_chunks=int(overlap_chunks)),
            x)
        return (res, tape), int(res.dropped)    # the one host read per attempt

    (res, tape), factor, attempts = run_with_capacity(attempt, policy)
    flat, vals = received_objects(res)
    report = tape.report(algorithm=f"SMMS(r={r})", t=t, n_in=n, n_out=n,
                         workload=res.count.cpu().numpy())
    report.exchange_topology = "flat" if staged_shape is None else "staged"
    report.theoretical_workload_bound = smms_workload_bound(n, t, r)
    report.total_dropped = 0
    report.cap_factor = factor
    report.capacity_attempts = attempts
    # the Algorithm-1 boundaries the run used, so a caller can recount
    # the workload (the reference keeps them in its SortResult only)
    report.boundaries = res.boundaries.cpu().numpy()
    return (flat, vals), report
