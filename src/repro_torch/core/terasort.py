"""Terasort with Algorithm S (paper §3.2), on one card.

Counterpart of ``src/repro/core/terasort.py`` (``terasort_shard`` :44,
``terasort_sort`` :116), the randomized baseline SMMS is measured
against.  Three rounds, written batched over the t machines:

  Round 1   each machine draws exactly q = ceil(ln(n t)) samples
            (Algorithm S) and they are all-gathered.
  Round 2   the boundaries are every ceil(s/t)-th of the s = t q pooled
            samples, in sorted order (every machine would compute the
            same; the port computes them once).
  Round 3   each machine sorts its row and cuts it at the boundaries in
            one kernel (``ops.sort_partition``; with values the fused
            pair sort ``ops.sort_partition_kv`` and one gather), then
            the flat static exchange and the merge of the landed rows,
            as in SMMS.

The draws are the caller's to give: ``uniforms`` (t, m) float32, one
per object, or ``seed`` for :func:`~repro_torch.core.sampling.draw_uniforms`
(ROADMAP C3).  Guarantee (Theorems 3-4): every machine receives at most
5m + 1 objects w.p. >= 1 - 1/n, so the receive capacity starts at
(5 + 1/m) x 1.1 and the retry loop recovers from the rare overflow.
``exchange="staged"`` gathers the samples in two hops and runs Round 3
as the staged exchange, as in SMMS (alpha 4, the same keys).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..cluster.capacity import CapacityPolicy, run_with_capacity
from ..cluster.collectives import CollectiveTape
from ..kernels.bitonic import ftz
from .alpha_k import terasort_workload_bound
from .exchange import exchange_sorted_segments
from .sampling import algorithm_s, draw_uniforms, terasort_sample_count
from .smms import SortResult, received_objects, resolve_exchange_topology

__all__ = ["boundary_index", "terasort_shard", "terasort_sort"]


def boundary_index(t: int, s_tot: int, device) -> torch.Tensor:
    """(t-1,) int32 positions ceil(i s_tot / t) - 1, i = 1..t-1, in the
    pooled sorted samples.  The quotient is taken in float32, as the
    reference's int32 / int true division takes it: where float32
    rounds it onto an integer, the ceiling differs from the exact one.
    """
    i = torch.arange(1, t, dtype=torch.int32, device=device)
    # divided by a tensor on the device: a CPU scalar divisor would let
    # CUDA multiply by its reciprocal instead
    quot = (i * s_tot).to(torch.float32) / torch.full(
        (), float(t), dtype=torch.float32, device=device)
    return torch.ceil(quot).to(torch.int32) - 1


def terasort_shard(x: torch.Tensor, uniforms: torch.Tensor, *, t: int,
                   q: int, cap_factor: float = 5.5,
                   values: Optional[torch.Tensor] = None,
                   staged_shape: Optional[tuple] = None,
                   overlap_chunks: int = 2,
                   tape: Optional[CollectiveTape] = None) -> SortResult:
    """The Terasort body for all t machines.  x: (t, m) unsorted keys;
    uniforms: (t, m) float32 Algorithm-S draws; values: (t, m, ...) or
    None.  ``staged_shape=(t1, t2)`` runs Round 3 as the staged
    exchange."""
    if tape is None:
        tape = CollectiveTape()

    # Round 1: Algorithm S, all-gathered, pooled and sorted.  The pooled
    # sort is a library sort in the reference too (jnp.sort): stable,
    # comparing with denormals folded.
    with tape.phase("round1->2 samples"):
        samples = algorithm_s(x, q, uniforms)                    # (t, q)
        if staged_shape is not None:
            samples = tape.all_gather_multi(samples, grid=staged_shape)
        else:
            samples = tape.all_gather(samples)
        flat = samples.reshape(-1)
        all_samples = flat[torch.sort(ftz(flat), stable=True).indices]

    # Round 2: every ceil(s/t)-th sample.
    with tape.phase("round2 boundaries"):
        idx = boundary_index(t, all_samples.shape[0], x.device)
        interior = all_samples[idx.long()]                       # (t-1,)

    # Round 3: fused sort and cut, exchange, merge; the staged exchange
    # declares its own phases.
    if staged_shape is not None:
        ex = exchange_sorted_segments(
            x, interior, t=t, cap_factor=cap_factor, values=values,
            sort_input=True, tape=tape, staged_shape=staged_shape,
            overlap_chunks=overlap_chunks, phase_prefix="round3 shuffle")
    else:
        with tape.phase("round3 shuffle"):
            ex = exchange_sorted_segments(
                x, interior, t=t, cap_factor=cap_factor, values=values,
                sort_input=True, tape=tape)
    b = torch.cat([all_samples[:1], interior, all_samples[-1:]])
    return SortResult(ex.keys, ex.values, ex.count, ex.sent, ex.dropped, b)


def terasort_sort(x: torch.Tensor, seed: int = 0,
                  cap_factor: Optional[float] = None,
                  policy: Optional[CapacityPolicy] = None,
                  values: Optional[torch.Tensor] = None,
                  uniforms: Optional[torch.Tensor] = None,
                  exchange: str = "flat", overlap_chunks: int = 2,
                  substrate=None):
    """Sort x of shape (t, m) across t machines, on x's device.

    ``uniforms`` (t, m) float32 are the Algorithm-S draws; None draws
    them from ``seed``.  Returns ``((sorted_keys, sorted_values),
    report)`` as :func:`~repro_torch.core.smms.smms_sort` does, the
    report carrying ``exchange_topology``, ``theoretical_workload_bound``
    (Theorem 3), ``cap_factor``, ``capacity_attempts`` and the
    boundaries.  An explicit ``cap_factor`` pins the capacity (no
    retry); otherwise Theorem 3 sizes it, with slack 1.1, and the
    policy retries on overflow.  ``exchange``, ``overlap_chunks`` and
    ``substrate`` as in :func:`~repro_torch.core.smms.smms_sort`.
    """
    t, m = x.shape
    n = t * m
    q = terasort_sample_count(n, t)
    substrate, staged_shape = resolve_exchange_topology(substrate, t,
                                                        exchange)
    if substrate.t != t:
        raise ValueError(f"{substrate!r} runs {substrate.t} machines; "
                         f"x has {t} rows")
    if uniforms is None:
        uniforms = draw_uniforms(t, m, seed, x.device)
    elif tuple(uniforms.shape) != (t, m):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)}; "
                         f"Algorithm S draws one per object, ({t}, {m})")
    uniforms = uniforms.to(device=x.device, dtype=torch.float32)
    if policy is None:
        policy = (CapacityPolicy.fixed(cap_factor) if cap_factor is not None
                  else CapacityPolicy.terasort(n, t, slack=1.1))

    def attempt(factor):
        res, tape = substrate.run(
            functools.partial(terasort_shard, t=t, q=q,
                              cap_factor=float(factor), values=values,
                              staged_shape=staged_shape,
                              overlap_chunks=int(overlap_chunks)),
            x, uniforms)
        return (res, tape), int(res.dropped)    # the one host read per attempt

    (res, tape), factor, attempts = run_with_capacity(attempt, policy)
    flat, vals = received_objects(res)
    report = tape.report(algorithm="Terasort+AlgS", t=t, n_in=n, n_out=n,
                         workload=res.count.cpu().numpy())
    report.exchange_topology = "flat" if staged_shape is None else "staged"
    report.theoretical_workload_bound = terasort_workload_bound(n, t)
    report.total_dropped = 0
    report.cap_factor = factor
    report.capacity_attempts = attempts
    # numpy has no bf16: bf16 boundaries (the samples) come out as
    # float32, exactly
    b = res.boundaries
    report.boundaries = (b.float() if b.dtype == torch.bfloat16
                         else b).cpu().numpy()
    return (flat, vals), report
