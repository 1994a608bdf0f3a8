"""Plan selection + the plan cache -- the planner's front half.

Counterpart of ``src/repro/planner/plan.py``.  ``plan_sort_query`` /
``plan_join_query`` run the sketch round on a substrate, score every
candidate through the cost model and return a :class:`QueryPlan`.
Plans are cached under a **fingerprint** -- a content hash of (dtype,
shape, bytes) of the inputs plus the query parameters -- so a repeated
query over the same data skips the sketch.  The bytes are hashed where
the run's rows already lie (:func:`tensor_digest`: weighted sums of
the words on the card, 16 bytes back to the host), not on the host:
a blake2b of a 16 MB sort input on the host cost more than the sketch
the cache skips (ROADMAP C17).  The cache is a bounded LRU
(``PLAN_CACHE_MAX`` entries) behind one lock.

``planner_stats()`` exposes the sketch-run / cache-hit counters, so a
caller can see the cache short-circuit the sketch.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..cluster.substrate import BatchedSubstrate, resolve_substrate
from ..obs import trace as obs_trace
from .cost import CostEstimate, choose_exchange, join_costs, select, sort_costs
from .sketch import profile_join_tables, profile_sorted_shards

__all__ = [
    "QueryPlan", "fingerprint_arrays", "plan_sort_query", "sketch_sort_plan",
    "plan_join_query", "plan_moe_query", "clear_plan_cache", "planner_stats",
    "PLAN_CACHE_MAX", "FINGERPRINT_LANES", "tensor_digest",
]

PLAN_CACHE_MAX = 128
FINGERPRINT_LANES = 2               # 128 bits, as the reference's digest

_PLAN_CACHE: "collections.OrderedDict[str, QueryPlan]" = \
    collections.OrderedDict()
_STATS = collections.Counter()
_LOCK = threading.RLock()


@dataclasses.dataclass
class QueryPlan:
    """One planning decision: profile, all candidate costs, the winner."""
    kind: str                        # "sort" | "join"
    algorithm: str                   # the chosen algorithm
    t: int
    fingerprint: str
    predicted: CostEstimate          # candidates[algorithm]
    candidates: Dict[str, CostEstimate]
    profile: object                  # TableProfile | DataProfile
    cached: bool = False             # served from the plan cache
    exchange: str = "flat"           # shuffle topology ("flat" | "staged")
    exchange_costs: Optional[Dict] = None   # choose_exchange details

    def summary(self) -> str:
        ranked = sorted(self.candidates.values(), key=lambda c: c.score)
        lines = [f"plan[{self.kind}] -> {self.algorithm}"
                 f" (exchange={self.exchange}, cached={self.cached}, "
                 f"fp={self.fingerprint[:12]})"]
        for c in ranked:
            mark = "*" if c.algorithm == self.algorithm else " "
            lines.append(
                f"  {mark} {c.algorithm:11s} alpha={c.alpha} "
                f"k_w={c.k_workload:6.2f} k_n={c.k_network:6.2f} "
                f"recv={c.peak_receive:10.0f} "
                f"bytes={c.bytes_shuffled:12.0f}"
                + ("" if c.feasible else "  [infeasible]"))
        return "\n".join(lines)


# splitmix64's increment and multipliers
_GOLDEN, _MIX1, _MIX2 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                         0x94D049BB133111EB)


def _i64(v: int) -> int:
    """The int64 holding the same 64 bits as the unsigned ``v``."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _weights(n: int, lane: int, device) -> torch.Tensor:
    """splitmix64 of i + (lane + 1) * golden for i < n, made odd."""
    z = (torch.arange(n, dtype=torch.int64, device=device)
         + _i64((lane + 1) * _GOLDEN))
    z = (z ^ _shr(z, 30)) * _i64(_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_MIX2)
    return (z ^ _shr(z, 31)) | 1


def tensor_digest(a: torch.Tensor) -> bytes:
    """FINGERPRINT_LANES 64-bit sums, taken where ``a`` lies, of its
    32-bit words (the bytes zero-padded to a whole word) each times an
    odd splitmix64 weight of its index, wrapping mod 2^64.  A change of
    one word always changes every sum (an odd weight times a nonzero
    difference below 2^32 is nonzero mod 2^64).  Only the sums come
    back to the host."""
    b = a.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(-b.numel() % 4)])
    words = b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sums = torch.stack([(_weights(words.numel(), lane, words.device)
                         * words).sum()
                        for lane in range(FINGERPRINT_LANES)])
    return sums.cpu().numpy().tobytes()


def fingerprint_arrays(*arrays, extra: str = "") -> str:
    """Content hash of (dtype, shape, :func:`tensor_digest`) per array
    + query params.  A host array is hashed on the host as a tensor."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(tensor_digest(a))
    h.update(extra.encode())
    return h.hexdigest()


def clear_plan_cache() -> None:
    with _LOCK:
        _PLAN_CACHE.clear()
        _STATS.clear()


def planner_stats() -> Dict[str, int]:
    """Counters: sketch_runs, cache_hits, cache_misses, cache_evictions."""
    with _LOCK:
        return dict(_STATS)


def _tick(counter: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[counter] += n


def _cache_get(key: str) -> Optional[QueryPlan]:
    with _LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is None:
            _STATS["cache_misses"] += 1
            return None
        _PLAN_CACHE.move_to_end(key)
        _STATS["cache_hits"] += 1
        return dataclasses.replace(plan, cached=True)


def _cache_put(key: str, plan: QueryPlan) -> None:
    with _LOCK:
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
            _STATS["cache_evictions"] += 1


def _sketch_substrate(substrate, t: int) -> BatchedSubstrate:
    """The substrate the sketch round runs on: the resolved one where
    it is a single axis of t machines (a pool's ``(t,)`` substrate, so
    its run counters see the sketch), else a fresh one."""
    sub = resolve_substrate(substrate, t)
    return sub if sub.t == t and len(sub.axes) == 1 else BatchedSubstrate(t)


def plan_sort_query(x, *, t: int, r: int = 2, device="cpu", x_device=None,
                    substrate=None):
    """Sketch -> score -> choose for ``cluster.sort(algorithm="auto")``.

    ``x`` is what the caller handed in; ``x_device``, when given, the
    same rows already on ``device``, else ``x`` is moved there.  The
    rows on the device are fingerprinted and sketched, on ``substrate``
    (a substrate, a provider or None, as ``cluster.sort`` takes it).
    Returns ``(QueryPlan, sketch_phases)``; the phases are [] on a
    cache hit (no sketch ran)."""
    if x_device is None:
        x_device = (x if isinstance(x, torch.Tensor)
                    else torch.as_tensor(np.asarray(x))).to(device)
    key = fingerprint_arrays(x_device, extra=f"sort|t={t}|r={r}")
    with obs_trace.span("plan.sort", t=t):
        plan = _cache_get(key)
        if plan is not None:
            obs_trace.event("plan.cache_hit", fingerprint=key[:12])
            return plan, []
        plan, phases = sketch_sort_plan(x_device, t=t, r=r, fingerprint=key,
                                        substrate=substrate)
        _cache_put(key, plan)
        return plan, phases


def sketch_sort_plan(x_device: torch.Tensor, *, t: int, r: int = 2,
                     fingerprint: str = "", substrate=None):
    """The sort plan with no cache: the sketch round on ``x_device``'s
    device, then the scores.  Returns ``(QueryPlan, sketch_phases)``."""
    _tick("sketch_runs")
    with obs_trace.span("planner.sketch"):
        profile, tape = profile_sorted_shards(
            x_device, _sketch_substrate(substrate, t))
    with obs_trace.span("planner.score"):
        costs = sort_costs(profile, t, r=r)
        chosen = select(costs)
        m = max(1, profile.n // t)
        topology, ex_costs = choose_exchange(
            t, m, algorithm=chosen.algorithm, r=r)
    plan = QueryPlan(kind="sort", algorithm=chosen.algorithm, t=t,
                     fingerprint=fingerprint, predicted=chosen,
                     candidates=costs, profile=profile, exchange=topology,
                     exchange_costs=ex_costs)
    return plan, tape.phases(t)


def plan_join_query(s_keys, t_keys, *, t_machines: int,
                    mem_budget: Optional[int] = None, device="cpu",
                    substrate=None):
    """Sketch -> score -> choose for ``cluster.join(algorithm="auto")``.

    The sketch runs on ``substrate`` as in :func:`plan_sort_query`.
    Returns ``(QueryPlan, sketch_phases)``."""
    from ..core.localjoin import MASKED_KEY

    t = t_machines
    s32 = torch.as_tensor(np.asarray(s_keys, np.int32)).to(device)
    t32 = torch.as_tensor(np.asarray(t_keys, np.int32)).to(device)
    key = fingerprint_arrays(s32, t32, extra=f"join|t={t}|mem={mem_budget}")
    with obs_trace.span("plan.join", t=t):
        plan = _cache_get(key)
        if plan is not None:
            obs_trace.event("plan.cache_hit", fingerprint=key[:12])
            return plan, []
        _tick("sketch_runs")
        with obs_trace.span("planner.sketch"):
            profile, tape = profile_join_tables(
                s32, t32, t, _sketch_substrate(substrate, t),
                masked=int(MASKED_KEY), device=device)
        with obs_trace.span("planner.score"):
            costs = join_costs(profile, t, mem_budget=mem_budget)
            chosen = select(costs)
        plan = QueryPlan(kind="join", algorithm=chosen.algorithm, t=t,
                         fingerprint=key, predicted=chosen, candidates=costs,
                         profile=profile)
        _cache_put(key, plan)
        return plan, tape.phases(t)


def plan_moe_query(*args, **kwargs):
    """The MoE dispatch planner waits for the MoE dispatch itself."""
    raise NotImplementedError(
        "plan_moe_query is not ported yet (MoE dispatch is ROADMAP "
        "queue A item A8)")
