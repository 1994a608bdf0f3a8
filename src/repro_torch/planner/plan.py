"""Plan selection + the plan cache -- the planner's front half.

Counterpart of ``src/repro/planner/plan.py``.  ``plan_sort_query`` /
``plan_join_query`` / ``plan_moe_query`` run the sketch round on a
substrate, score every candidate through the cost model and return a
:class:`QueryPlan`.
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

On a ``ProcessGroupSubstrate`` the sketch round is collective, so the
ranks must agree on a cache hit: each rank looks its cache up, the
group takes the minimum of the hit flags (one ``all_reduce``), and
unless every rank hit, every rank sketches (a rank that hit counts a
miss).  The fingerprint is taken on the whole operands, which every
rank holds, so the key is the same on every rank.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..cluster.substrate import (BatchedSubstrate, ProcessGroupSubstrate,
                                 resolve_substrate)
from ..obs import trace as obs_trace
from .cost import (CostEstimate, choose_exchange, join_costs,
                   moe_dispatch_costs, select, select_dispatch, sort_costs)
from .sketch import (expert_counts_estimate, profile_join_tables,
                     profile_sorted_shards, sketch_table)

__all__ = [
    "QueryPlan", "fingerprint_arrays", "plan_sort_query", "sketch_sort_plan",
    "plan_join_query", "plan_moe_query", "sketch_moe_plan", "routing_ids",
    "clear_plan_cache", "planner_stats", "PLAN_CACHE_MAX",
    "FINGERPRINT_LANES", "tensor_digest",
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
    kind: str                        # "sort" | "join" | "moe"
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


def _sketch_substrate(substrate, t: int):
    """The substrate the sketch round runs on: the resolved one where
    it is a single axis of t machines (a pool's ``(t,)`` substrate, so
    its run counters see the sketch; a process group's too), else a
    fresh batch (the reference's rule, ``src/repro/planner/plan.py:151``)."""
    sub = resolve_substrate(substrate, t)
    return sub if sub.t == t and len(sub.axes) == 1 else BatchedSubstrate(t)


def _agreed_cache_get(key: str, sub) -> Optional[QueryPlan]:
    """:func:`_cache_get`, agreed over ``sub``'s group where the sketch
    runs on one: the plan only if every rank of the group hit."""
    plan = _cache_get(key)
    if not isinstance(sub, ProcessGroupSubstrate) or sub.world == 1:
        return plan
    import torch.distributed as dist
    dev = ("cuda" if "nccl" in str(dist.get_backend(sub.group)).lower()
           else "cpu")
    hit = torch.tensor([int(plan is not None)], dtype=torch.int32,
                       device=dev)
    dist.all_reduce(hit, op=dist.ReduceOp.MIN, group=sub.group)
    if plan is not None and not int(hit.item()):
        _tick("cache_hits", -1)
        _tick("cache_misses")
        return None
    return plan


def plan_sort_query(x, *, t: int, r: int = 2, device=None, x_device=None,
                    substrate=None):
    """Sketch -> score -> choose for ``cluster.sort(algorithm="auto")``.

    ``x`` is what the caller handed in; ``x_device``, when given, the
    same rows already on ``device``, else ``x`` is moved there.  The
    rows on the device are fingerprinted and sketched, on ``substrate``
    (a substrate, a provider or None, as ``cluster.sort`` takes it).
    ``device`` None is the card (``device.resolve_device``).
    Returns ``(QueryPlan, sketch_phases)``; the phases are [] on a
    cache hit (no sketch ran)."""
    device = resolve_device(device)
    if x_device is None:
        x_device = (x if isinstance(x, torch.Tensor)
                    else torch.as_tensor(np.asarray(x))).to(device)
    key = fingerprint_arrays(x_device, extra=f"sort|t={t}|r={r}")
    sub = _sketch_substrate(substrate, t)
    with obs_trace.span("plan.sort", t=t):
        plan = _agreed_cache_get(key, sub)
        if plan is not None:
            obs_trace.event("plan.cache_hit", fingerprint=key[:12])
            return plan, []
        plan, phases = sketch_sort_plan(x_device, t=t, r=r, fingerprint=key,
                                        substrate=sub)
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
                    mem_budget: Optional[int] = None, device=None,
                    substrate=None):
    """Sketch -> score -> choose for ``cluster.join(algorithm="auto")``.

    The sketch runs on ``substrate`` and ``device`` (None: the card) as
    in :func:`plan_sort_query`.  Returns ``(QueryPlan, sketch_phases)``."""
    from ..core.localjoin import MASKED_KEY

    device = resolve_device(device)
    t = t_machines
    s32 = torch.as_tensor(np.asarray(s_keys, np.int32)).to(device)
    t32 = torch.as_tensor(np.asarray(t_keys, np.int32)).to(device)
    key = fingerprint_arrays(s32, t32, extra=f"join|t={t}|mem={mem_budget}")
    sub = _sketch_substrate(substrate, t)
    with obs_trace.span("plan.join", t=t):
        plan = _agreed_cache_get(key, sub)
        if plan is not None:
            obs_trace.event("plan.cache_hit", fingerprint=key[:12])
            return plan, []
        _tick("sketch_runs")
        with obs_trace.span("planner.sketch"):
            profile, tape = profile_join_tables(
                s32, t32, t, sub, masked=int(MASKED_KEY), device=device)
        with obs_trace.span("planner.score"):
            costs = join_costs(profile, t, mem_budget=mem_budget)
            chosen = select(costs)
        plan = QueryPlan(kind="join", algorithm=chosen.algorithm, t=t,
                         fingerprint=key, predicted=chosen, candidates=costs,
                         profile=profile)
        _cache_put(key, plan)
        return plan, tape.phases(t)


def routing_ids(x: torch.Tensor, router: torch.Tensor, *, t: int,
                top_k: int) -> torch.Tensor:
    """The (t, m * top_k) int32 expert ids the cluster dispatch's Round 1
    computes for x (tokens, d) dealt to t machines in contiguous blocks:
    the same routing expression (``models.moe.route``), so the sketched
    ids are the run's ids."""
    from ..models.moe import route
    return route(x.reshape(t, -1, x.shape[-1]), router,
                 top_k)[1].reshape(t, -1)


def plan_moe_query(x, router, *, t_machines: int, num_experts: int,
                   top_k: int, extra_slots: int,
                   capacity_factor: float = 1.25, device=None,
                   substrate=None):
    """Sketch -> score -> choose for ``cluster.moe_dispatch(mode="auto")``
    (and the cluster mode's counts).

    The sketched table is the router's top-k expert-id stream: routing
    is a join keyed by expert id, so the heavy-hitter / CountMin
    machinery that prices skew joins prices dispatch skew.  x (tokens,
    d) and the router are moved to ``device`` (None: the card; tensors
    already there are not copied), fingerprinted there (:func:`tensor_digest`) and the
    ids sketched there, on ``substrate``.  Returns ``(QueryPlan,
    sketch_phases)``; ``plan.profile`` is the ids' TableProfile, and
    ``sketch.expert_counts_estimate`` re-derives the per-expert counts
    from it.  The phases are [] on a cache hit.
    """
    device = resolve_device(device)
    t = t_machines
    xd, rd = (a if isinstance(a, torch.Tensor)
              else torch.from_numpy(np.array(a)) for a in (x, router))
    xd, rd = xd.to(device), rd.to(device)
    key = fingerprint_arrays(
        xd, rd, extra=f"moe|t={t}|e={num_experts}|k={top_k}"
                      f"|r={extra_slots}|cf={capacity_factor}")
    sub = _sketch_substrate(substrate, t)
    with obs_trace.span("plan.moe", t=t):
        plan = _agreed_cache_get(key, sub)
        if plan is not None:
            obs_trace.event("plan.cache_hit", fingerprint=key[:12])
            return plan, []
        plan, phases = sketch_moe_plan(
            routing_ids(xd, rd, t=t, top_k=top_k), num_experts=num_experts,
            top_k=top_k, extra_slots=extra_slots,
            capacity_factor=capacity_factor, fingerprint=key,
            substrate=sub)
        _cache_put(key, plan)
        return plan, phases


def sketch_moe_plan(ids: torch.Tensor, *, num_experts: int, top_k: int,
                    extra_slots: int, capacity_factor: float = 1.25,
                    fingerprint: str = "", substrate=None):
    """The MoE plan with no cache, from the (t, m * top_k) int32 routing
    ids (:func:`routing_ids`): the sketch round on their device, every
    id counted (no subsampling), then the dispatch costs.  Returns
    ``(QueryPlan, sketch_phases)``."""
    t = ids.shape[0]
    _tick("sketch_runs")
    with obs_trace.span("planner.sketch"):
        profile, tape = sketch_table(ids.to(torch.int32),
                                     _sketch_substrate(substrate, t),
                                     sample=None)
    with obs_trace.span("planner.score"):
        counts = expert_counts_estimate(profile, num_experts)
        costs = moe_dispatch_costs(
            counts, tokens=ids.numel() // top_k, top_k=top_k,
            num_experts=num_experts, extra_slots=extra_slots, t_machines=t,
            capacity_factor=capacity_factor)
        chosen = select_dispatch(costs)
    plan = QueryPlan(kind="moe", algorithm=chosen.algorithm, t=t,
                     fingerprint=fingerprint, predicted=chosen,
                     candidates=costs, profile=profile)
    return plan, tape.phases(t)
