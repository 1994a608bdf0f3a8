"""StatJoin (paper §4.3): deterministic skew equi-join via statistics.

Counterpart of ``src/repro/core/statjoin.py``.  Rounds 1-2 sort S and T
by join key and collect the per-key counts (M_k, N_k), the statistics.
Round 3 maps join results to machines with a deterministic planner,
routes tuples per plan, and each machine cross-products what it
receives (:func:`~repro_torch.core.localjoin.local_equijoin`, batched
over the machines on the card).

The planner and the routing are host numpy, as in the reference, and
give the reference's plan and fragments exactly; where the reference
loops in Python over every rectangle, this module works on arrays:

* a key's result is **big** if M_k N_k > W/t (exact integers: M_k N_k t
  > W); a big result is cut into j = ceil(M_k N_k t / W) rectangles
  along its longer side, the j-1 largest go to fresh machines and the
  residual joins the small pool unless M_k N_k t == j W;
* small results and residuals go, in order, to the least-loaded machine
  (lowest index on ties).  A heap of (load, machine) pops exactly what
  ``argmin`` over the loads picks.

Theorem 6: every machine's output is at most 2W/t -- the static output
capacity per machine.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..cluster.substrate import resolve_substrate
from .alpha_k import statjoin_workload_bound
from .localjoin import MASKED_KEY, local_equijoin

__all__ = ["JoinStatistics", "Rectangle", "StatJoinPlan",
           "collect_statistics", "plan_statjoin", "statjoin"]


@dataclasses.dataclass(frozen=True)
class JoinStatistics:
    keys: np.ndarray   # (k,) join keys present in both tables
    m: np.ndarray      # (k,) multiplicity in S
    n: np.ndarray      # (k,) multiplicity in T

    @property
    def sizes(self) -> np.ndarray:
        return self.m.astype(np.int64) * self.n.astype(np.int64)

    @property
    def total(self) -> int:
        return int(self.sizes.sum())


@dataclasses.dataclass(frozen=True)
class Rectangle:
    """One result-to-machine mapping entry: key x [s_lo,s_hi) x [t_lo,t_hi)."""
    key: int
    s_lo: int
    s_hi: int
    t_lo: int
    t_hi: int
    machine: int

    @property
    def size(self) -> int:
        return (self.s_hi - self.s_lo) * (self.t_hi - self.t_lo)


_FIELDS = ("key", "s_lo", "s_hi", "t_lo", "t_hi", "machine")


@dataclasses.dataclass(frozen=True)
class StatJoinPlan:
    """The planner's rectangles as int64 columns, in plan order.

    A sequence of :class:`Rectangle` (``len``, iteration, indexing), so
    it reads like the reference's ``List[Rectangle]``.
    """
    key: np.ndarray
    s_lo: np.ndarray
    s_hi: np.ndarray
    t_lo: np.ndarray
    t_hi: np.ndarray
    machine: np.ndarray

    @classmethod
    def from_rows(cls, rows) -> "StatJoinPlan":
        cols = np.asarray(rows, np.int64).reshape(-1, len(_FIELDS)).T
        return cls(*(np.ascontiguousarray(c) for c in cols))

    def __len__(self) -> int:
        return len(self.key)

    def __getitem__(self, i: int) -> Rectangle:
        return Rectangle(*(int(getattr(self, f)[i]) for f in _FIELDS))

    def __iter__(self) -> Iterator[Rectangle]:
        cols = [getattr(self, f).tolist() for f in _FIELDS]
        return (Rectangle(*row) for row in zip(*cols))


def collect_statistics(s_keys: np.ndarray, t_keys: np.ndarray
                       ) -> JoinStatistics:
    """Per-key multiplicities for keys present in both tables."""
    ks, cs = np.unique(s_keys, return_counts=True)
    kt, ct = np.unique(t_keys, return_counts=True)
    common, is_, it_ = np.intersect1d(ks, kt, return_indices=True)
    return JoinStatistics(common, cs[is_], ct[it_])


def _split_big(key: int, m_k: int, n_k: int, t: int, w: int):
    """A big result's rectangles: (assigned, residual or None), each a
    (key, s_lo, s_hi, t_lo, t_hi) row; the reference's §4.3.2 split."""
    mn = m_k * n_k
    j = -(-mn * t // w)                 # ceil(MN / (W/t)), exact integers
    split_s = m_k >= n_k
    longer = m_k if split_s else n_k
    j = min(j, longer)                  # at most one tuple per interval
    base, extra = divmod(longer, j)
    pieces, lo = [], 0
    for p in range(j):
        size = base + (1 if p < extra else 0)
        pieces.append((lo, lo + size))
        lo += size
    pieces.sort(key=lambda ab: ab[1] - ab[0], reverse=True)
    rect = ((lambda a, b: (key, a, b, 0, n_k)) if split_s
            else (lambda a, b: (key, 0, m_k, a, b)))
    exact = mn * t == j * w             # MN == j * W/t, exactly
    assigned = [rect(*p) for p in (pieces if exact else pieces[:-1])]
    return assigned, (None if exact else rect(*pieces[-1]))


def plan_statjoin(stats: JoinStatistics, t: int) -> StatJoinPlan:
    """§4.3.2/4.3.3 planner: the result-to-machine mapping."""
    w = stats.total
    if w == 0:
        return StatJoinPlan.from_rows([])
    big = stats.sizes * t > w
    loads = [0] * t
    placed = []                         # big rectangles on fresh machines
    pool = []                           # residuals, then the small results
    next_machine = 0
    for key, m_k, n_k in zip(stats.keys[big].tolist(), stats.m[big].tolist(),
                             stats.n[big].tolist()):
        assigned, residual = _split_big(key, m_k, n_k, t, w)
        for r in assigned:
            if next_machine < t:
                placed.append(r + (next_machine,))
                loads[next_machine] += (r[2] - r[1]) * (r[4] - r[3])
                next_machine += 1
            else:   # cannot happen when sum(j_B - 1) <= t; guard anyway
                pool.append(r)
        if residual is not None:
            pool.append(residual)
    small = ~big
    n_small = int(small.sum())
    pool_cols = np.asarray(pool, np.int64).reshape(-1, 5)
    small_cols = np.stack([stats.keys[small].astype(np.int64),
                           np.zeros(n_small, np.int64),
                           stats.m[small].astype(np.int64),
                           np.zeros(n_small, np.int64),
                           stats.n[small].astype(np.int64)], axis=1)
    pool_cols = np.concatenate([pool_cols, small_cols])
    sizes = ((pool_cols[:, 2] - pool_cols[:, 1])
             * (pool_cols[:, 4] - pool_cols[:, 3])).tolist()
    # greedy: next small result to the least-loaded machine (§4.3.3)
    heap = [(load, i) for i, load in enumerate(loads)]
    heapq.heapify(heap)
    machine = np.empty(len(sizes), np.int64)
    for i, size in enumerate(sizes):
        load, mach = heap[0]
        machine[i] = mach
        heapq.heapreplace(heap, (load + size, mach))
    placed_cols = np.asarray(placed, np.int64).reshape(-1, 6)
    pool_cols = np.concatenate([pool_cols, machine[:, None]], axis=1)
    return StatJoinPlan.from_rows(np.concatenate([placed_cols, pool_cols]))


def _routing_tensors(keys: np.ndarray, plan: StatJoinPlan, t: int,
                     side: str) -> Tuple[np.ndarray, int]:
    """Per-machine padded index lists of table rows, per the plan.

    keys: the table's key column.  side: 's' or 't' picks the rectangle
    range.  Machine i's list is its rectangles' row ranges in plan order,
    each range the stable key order's rows [base + lo, base + hi) of the
    key's group; -1 pads.
    """
    order = np.argsort(keys, kind="stable")      # ranks within key group
    uk, first = np.unique(keys[order], return_index=True)
    lo, hi = (plan.s_lo, plan.s_hi) if side == "s" else (plan.t_lo, plan.t_hi)
    at = np.clip(np.searchsorted(uk, plan.key), 0, max(len(uk) - 1, 0))
    found = (uk[at] == plan.key) if len(uk) else np.zeros(len(plan), bool)
    keep = np.nonzero(found & (hi > lo))[0]
    keep = keep[np.argsort(plan.machine[keep], kind="stable")]
    lens = hi[keep] - lo[keep]
    starts = first[at[keep]] + lo[keep]
    total = int(lens.sum())
    ends = np.cumsum(lens)
    src = np.repeat(starts - (ends - lens), lens) + np.arange(total)
    mach = np.repeat(plan.machine[keep], lens)
    per_machine = np.bincount(mach, minlength=t)
    cap = max(1, int(per_machine.max(initial=0)))
    col = np.arange(total) - np.repeat(np.cumsum(per_machine) - per_machine,
                                       per_machine)
    out = np.full((t, cap), -1, dtype=np.int64)
    out[mach, col] = order[src]
    return out, cap


def _statjoin_body(a, b, c, d, *, tape, n_in, n_stat, t, capacity):
    """The StatJoin body for all t machines: (t, n) routed fragments."""
    # Rounds 1-2: the SMMS sort that produced the statistics -- each
    # tuple crosses the network once (n/t per machine, paper §4.3.1).
    with tape.phase("rounds1-2 sort+stats"):
        tape.record(sent=n_in / t, received=n_in / t)
    # Round 3a: every machine learns the per-key statistics so it can
    # run the (deterministic, replicated) planner.
    with tape.phase("round3 stats->plan"):
        tape.record(sent=n_stat, received=n_stat)
    # Round 3b: tuples routed per plan; the received count is measured
    # from the landed fragments (a replicated tuple counts once per
    # copy -- the paper's network cost of rectangles).
    with tape.phase("round3 route"):
        received = (a != MASKED_KEY).sum(1) + (c != MASKED_KEY).sum(1)
        tape.record(sent=n_in / t, received=received)
        return local_equijoin(a, b, c, d, capacity)


def statjoin(s_keys: np.ndarray, s_rows: np.ndarray,
             t_keys: np.ndarray, t_rows: np.ndarray, t_machines: int,
             out_cap_factor: float = 1.05,
             stats: Optional[JoinStatistics] = None,
             out_capacity: Optional[int] = None, device="cuda",
             substrate=None):
    """Plan on statistics (host), then join on ``device``, batched.

    Returns (JoinOutput, report).  ``out_capacity`` overrides the
    Theorem-6 output slots per machine, ceil(out_cap_factor * 2W/t).
    ``substrate``: a substrate, a provider (called with ``(t,)``) or
    None, the process-wide pool.
    """
    t = t_machines
    s_keys = np.asarray(s_keys, np.int32)
    t_keys = np.asarray(t_keys, np.int32)
    if stats is None:
        stats = collect_statistics(s_keys, t_keys)
    plan = plan_statjoin(stats, t)
    w = stats.total

    def frag(keys, rows, side):
        idx, _ = _routing_tensors(keys, plan, t, side)
        safe = np.clip(idx, 0, len(keys) - 1)
        k = np.where(idx >= 0, keys[safe], MASKED_KEY).astype(np.int32)
        v = np.where(idx >= 0, np.asarray(rows)[safe], 0).astype(np.int32)
        return (torch.from_numpy(k).to(device),
                torch.from_numpy(v).to(device))

    sk, sr = frag(s_keys, s_rows, "s")
    tk, tr = frag(t_keys, t_rows, "t")
    capacity = (int(out_capacity) if out_capacity is not None
                else max(1, math.ceil(
                    out_cap_factor * statjoin_workload_bound(w, t))))
    n_in = len(s_keys) + len(t_keys)
    body = functools.partial(_statjoin_body, n_in=n_in, n_stat=len(stats.keys),
                             t=t, capacity=capacity)
    out, tape = resolve_substrate(substrate, t).run(body, sk, sr, tk, tr)
    report = tape.report(algorithm="StatJoin", t=t, n_in=n_in, n_out=w,
                         workload=out.count.cpu().numpy())
    report.theoretical_workload_bound = statjoin_workload_bound(w, t)
    report.plan = plan
    return out, report
