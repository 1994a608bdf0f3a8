"""SMMS -- Sort-Map-Merge Sort (paper §3.1).

Counterpart of ``src/repro/core/smms.py`` (``smms_shard`` :111,
``smms_sort`` :201).  Three rounds, written batched over the machines a
substrate hands the body (all t on one card; a rank's share of them in
a process group, where every rank computes Round 2 alike):

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
attempt.  Guarantee (Thm 2): (3, 1 + 2/r + r t^3/n)-minimal for
t^3 <= n.  Under ``obs.trace`` the call is spanned where its work
happens: each attempt, each round (the tape's phases), Round 3's
pack, all-to-all and merge, the output's collection, the report, and
every host read (``sync:<site>``).

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
from ..cluster.substrate import Substrate, resolve_substrate
from ..kernels import ops
from ..obs import trace as obs_trace
from .alpha_k import smms_workload_bound
from .boundaries import boundaries, equidepth_samples
from .exchange import exchange_sorted_segments

__all__ = ["smms_shard", "smms_sort", "SortResult", "default_cap_factor",
           "received_objects", "resolve_exchange_topology", "sort_report",
           "tile_attrs"]


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
    explicit = isinstance(substrate, Substrate)
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
    and their values (or None).  Each boolean-mask gather reads its
    length back to the host (a ``sync:collect.*`` span)."""
    valid = (torch.arange(res.keys.shape[1], device=res.keys.device)[None, :]
             < res.count[:, None].long())
    with obs_trace.sync("collect.keys", valid.is_cuda):
        keys = res.keys[valid]
    if res.values is None:
        return keys, None
    with obs_trace.sync("collect.values", valid.is_cuda):
        return keys, res.values[valid]


def tile_attrs(res: SortResult) -> None:
    """Put the attempt's output tiles' slots and bytes (its keys and
    values, over all t machines) on the open ``capacity.attempt``
    span, if a trace is open."""
    sp = obs_trace.current()
    if sp is not None:
        sp.attrs["tile_slots"] = res.keys.numel()
        sp.attrs["tile_bytes"] = res.keys.nbytes + (
            0 if res.values is None else res.values.nbytes)


def sort_report(tape, res: SortResult, algorithm: str, t: int, n: int):
    """The front door's report: the tape's phases, each machine's count
    and the boundaries, each read back to the host under a ``sync:``
    span."""
    with obs_trace.sync("count", res.count.is_cuda):
        workload = res.count.cpu().numpy()
    report = tape.report(algorithm=algorithm, t=t, n_in=n, n_out=n,
                         workload=workload)
    # numpy has no bf16: bf16 boundaries (Terasort's samples) come out
    # as float32, exactly
    b = res.boundaries
    with obs_trace.sync("boundaries", b.is_cuda):
        report.boundaries = (b.float() if b.dtype == torch.bfloat16
                             else b).cpu().numpy()
    return report


def default_cap_factor(n: int, t: int, r: int, slack: float = 1.05) -> float:
    """Static receive capacity from Theorem 1, with a small safety slack."""
    return CapacityPolicy.smms(n, t, r, slack=slack).first_factor


def smms_shard(x: torch.Tensor, values: Optional[torch.Tensor] = None, *,
               t: int, r: int = 2, cap_factor: Optional[float] = None,
               staged_shape: Optional[tuple] = None,
               overlap_chunks: int = 2, backend: str = "static",
               tape: Optional[CollectiveTape] = None) -> SortResult:
    """The SMMS body for the machines the tape holds.  x: (rows, m), a
    row a machine's keys (all t on the batch); values: (rows, m, ...)
    their payload, or None.  ``staged_shape=(t1, t2)`` runs Round 3 as
    the staged exchange, ``backend="ragged"`` as the exact-size one.
    The dropped count and the boundaries come out whole on every
    machine (``tape.replicated``)."""
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
            valid_len=m, backend=backend, tape=tape,
            staged_shape=staged_shape,
            overlap_chunks=overlap_chunks, phase_prefix="round3 shuffle")
    else:
        with tape.phase("round3 shuffle"):
            ex = exchange_sorted_segments(
                xs, b[1:-1], t=t, cap_factor=cap_factor, values=values,
                valid_len=m, backend=backend, tape=tape)
    return SortResult(ex.keys, ex.values, ex.count, ex.sent,
                      tape.replicated(ex.dropped), tape.replicated(b))


def smms_sort(x: torch.Tensor, r: int = 2, cap_factor: Optional[float] = None,
              policy: Optional[CapacityPolicy] = None,
              values: Optional[torch.Tensor] = None,
              exchange: str = "flat", overlap_chunks: int = 2,
              backend: str = "static", substrate=None):
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
    ``report.exchange_topology`` says which ran.  ``backend``: the
    shuffle's ``"static"`` tiles or its ``"ragged"`` exact-size
    segments (a ``ProcessGroupSubstrate``'s only; flat only).
    ``substrate`` as :func:`resolve_exchange_topology` takes it.
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

    # the values travel as an operand: a process group hands each rank
    # its rows of both
    operands = (x,) if values is None else (x, values)

    def attempt(factor):
        res, tape = substrate.run(
            functools.partial(smms_shard, t=t, r=r, cap_factor=float(factor),
                              staged_shape=staged_shape,
                              overlap_chunks=int(overlap_chunks),
                              backend=backend),
            *operands)
        tile_attrs(res)
        # the one host read an attempt
        with obs_trace.sync("dropped", res.dropped.is_cuda):
            return (res, tape), int(res.dropped)

    (res, tape), factor, attempts = run_with_capacity(attempt, policy)
    with obs_trace.span("sort.collect"):
        flat, vals = received_objects(res)
    with obs_trace.span("sort.report"):
        # the Algorithm-1 boundaries the run used ride on the report, so
        # a caller can recount the workload (the reference keeps them in
        # its SortResult only)
        report = sort_report(tape, res, f"SMMS(r={r})", t, n)
    report.exchange_topology = "flat" if staged_shape is None else "staged"
    report.theoretical_workload_bound = smms_workload_bound(n, t, r)
    report.total_dropped = 0
    report.cap_factor = factor
    report.capacity_attempts = attempts
    return (flat, vals), report
