"""The (alpha, k) cost model — theorem bounds turned into predictions.

A copy of ``src/repro/planner/cost.py`` (pure Python; the port imports
nothing of the reference package).

Every candidate algorithm gets a :class:`CostEstimate`: predicted alpha
(rounds), predicted k (workload and network), total bytes shuffled and
peak per-machine receive.  The *bounds* come straight from the paper —
Theorem 1/2 (SMMS), Theorem 3/4 (Terasort+AlgS), Corollary 3/Theorem 5
(RandJoin), Theorem 6/7 (StatJoin) — but a bound is a worst case, and a
planner that predicts the worst case always overshoots the measured k
by the full slack.  Predictions therefore sit at the *expected-case*
point of each theorem's interval (half the sampling slack for SMMS, the
``TERASORT_EXPECTED_K`` midpoint for Terasort's 5m+1, the midpoint of
[W/t, 2W/t] for StatJoin/RandJoin outputs), floored at the skew terms
the sketches expose: a key's duplicates can never be split across
boundary buckets, and a repartitioned hot key's whole result lands on
one machine.

Selection minimizes a per-machine wall-clock proxy in object units:
``peak_workload + peak_receive + ROUND_COST_OBJECTS * alpha`` —
workload and network weighted equally (the paper's Ineq. 1/2 treat
them symmetrically) plus a small per-round synchronization charge so a
(1, k) algorithm beats a (3, k) algorithm on otherwise-equal costs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from ..core.sampling import terasort_sample_count

__all__ = [
    "ROUND_COST_OBJECTS", "BROADCAST_MEM_BUDGET", "TERASORT_EXPECTED_K",
    "CostEstimate", "sort_costs", "join_costs", "select",
    "moe_dispatch_costs", "select_dispatch",
    "exchange_costs", "choose_exchange",
]

# Objects-equivalent charge of one synchronized round (barrier latency).
ROUND_COST_OBJECTS = 64.0
# Per-machine memory budget (objects) a broadcast table must fit in.
BROADCAST_MEM_BUDGET = 1 << 20
# Expected-case max-load factor for Terasort's sampled boundaries
# (Theorem 3 bounds it at 5; the paper's Figs 8-10 measure 1.5-2.5).
TERASORT_EXPECTED_K = 2.0
# Hash-partition balance penalty: with d distinct keys over t machines
# the max bucket overshoots the mean by ~c/sqrt(d/t) (balls-in-bins),
# on TOP of the hot-key pinning term.  Repartition has no theorem
# shielding it; the other algorithms price their theorem bounds.
REPARTITION_VARIANCE = 3.0
OBJECT_BYTES = 4.0

# Deterministic tie-break: prefer deterministic bounds over randomized,
# fewer rounds over more, when scores tie exactly.
_PREFERENCE = ("statjoin", "broadcast", "smms", "randjoin", "terasort",
               "repartition")


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Predicted (alpha, k, bytes-shuffled, peak-receive) for one algorithm."""
    algorithm: str
    alpha: int                 # predicted synchronized rounds
    k_workload: float          # predicted max_i W_i / (W_seq / t)
    k_network: float           # predicted max_i N_i / (N / t)
    bytes_shuffled: float      # total bytes crossing the network
    peak_receive: float        # max per-machine objects received, any round
    peak_workload: float       # max per-machine workload (objects)
    w_seq: float               # normalizer used for k_workload
    feasible: bool = True
    note: str = ""

    @property
    def score(self) -> float:
        """Per-machine wall-clock proxy in object units (lower = better)."""
        if not self.feasible:
            return math.inf
        return (self.peak_workload + self.peak_receive
                + ROUND_COST_OBJECTS * self.alpha)


# ---------------------------------------------------------------------------
# sort: SMMS (Thm 1/2) vs Terasort+AlgS (Thm 3/4)
# ---------------------------------------------------------------------------

def sort_costs(profile, t: int, r: int = 2) -> Dict[str, CostEstimate]:
    """Candidate costs for sorting the profiled (t, m) input."""
    n = max(profile.n, 1)
    m = n / t
    n_total = 2.0 * n           # every object in + out
    top = profile.top_count     # duplicates of one key cannot be split

    # SMMS, Theorem 1: round-3 receive <= (1 + 2/r + t^2/n) m.  Expected
    # case sits at half the 2/r sampling slack; a heavy duplicate run
    # floors it (equal keys share a bucket).  Every machine also gathers
    # all t * (rt + 1) equi-depth samples in round 1 — the term that
    # makes SMMS lose when t^3 outgrows n (Thm 2's r t^3/n).
    smms_peak = max(m * (1.0 + 1.0 / r + t * t / n), top)
    smms_recv = max(smms_peak, float(t * (r * t + 1)))
    smms = CostEstimate(
        algorithm="smms", alpha=3,
        k_workload=smms_peak / m,
        k_network=(smms_recv + m) / (n_total / t),
        bytes_shuffled=OBJECT_BYTES * (n + t * t * (r * t + 1)),
        peak_receive=smms_recv, peak_workload=smms_peak, w_seq=float(n),
        note=f"Thm 1 bound {(1 + 2 / r + t * t / n):.3f}m")

    # Terasort, Theorem 3: receive <= 5m + 1 w.h.p.; measured max loads
    # cluster around TERASORT_EXPECTED_K * m (paper Figs 8-10).  Its
    # round-1 gather is only t*q = t*ceil(ln nt) samples (Thm 4's t^3/n
    # has no r factor) — the regime where Terasort beats SMMS.
    q = terasort_sample_count(n, t)
    tera_peak = max(m * min(5.0 + 1.0 / m, TERASORT_EXPECTED_K), top)
    tera_recv = max(tera_peak, float(t * q))
    tera = CostEstimate(
        algorithm="terasort", alpha=3,
        k_workload=tera_peak / m,
        k_network=(tera_recv + m) / (n_total / t),
        bytes_shuffled=OBJECT_BYTES * (n + t * t * q),
        peak_receive=tera_recv, peak_workload=tera_peak, w_seq=float(n),
        note=f"Thm 3 bound 5m+1, q={q}")
    return {"smms": smms, "terasort": tera}


# ---------------------------------------------------------------------------
# join: StatJoin (Thm 6/7), RandJoin (Cor 3/Thm 5), Broadcast, Repartition
# ---------------------------------------------------------------------------

def join_costs(profile, t: int,
               mem_budget: Optional[int] = None) -> Dict[str, CostEstimate]:
    """Candidate costs for joining the profiled table pair."""
    from ..core.randjoin import choose_ab

    mem_budget = BROADCAST_MEM_BUDGET if mem_budget is None else mem_budget
    ns, nt = profile.s.n, profile.t.n
    n_in = max(ns + nt, 1)
    w = max(profile.est_join_size, 1.0)
    w_seq = max(float(n_in), w)
    n_total = n_in + w
    maxprod = profile.max_heavy_product

    def mk(algorithm, alpha, peak_workload, peak_receive, moved, note=""):
        return CostEstimate(
            algorithm=algorithm, alpha=alpha,
            k_workload=peak_workload / (w_seq / t),
            k_network=2.0 * peak_receive / (n_total / t),
            bytes_shuffled=OBJECT_BYTES * moved,
            peak_receive=peak_receive, peak_workload=peak_workload,
            w_seq=w_seq, note=note)

    # Repartition: hash-partition both sides; a hot key's entire result
    # (and all its input tuples) pins to one machine — the baseline the
    # paper's Fig 11/13 exhibits — and even keyset-uniform inputs pay
    # balls-in-bins variance on the per-machine key count.
    top_in = profile.s.top_count + profile.t.top_count
    distinct = max(profile.s.distinct, profile.t.distinct, 1.0)
    balance = 1.0 + REPARTITION_VARIANCE / math.sqrt(max(distinct / t, 1.0))
    repart = mk("repartition", 1,
                peak_workload=(w / t) * balance + maxprod,
                peak_receive=n_in / t + top_in,
                moved=float(n_in),
                note="skew-vulnerable: hot key -> one machine")

    # StatJoin, Theorem 6: output <= 2W/t deterministically; rounds 1-2
    # sort both tables (n/t each way), round 3 routes per rectangle plan.
    stat = mk("statjoin", 3,
              peak_workload=1.5 * w / t,
              peak_receive=n_in / t,
              moved=2.0 * n_in + t * max(profile.s.distinct,
                                         profile.t.distinct),
              note="Thm 6: <= 2W/t deterministic")

    # RandJoin, Cor 3: output < 2W/t w.h.p.; replication moves
    # b|S| + a|T| objects and every machine receives |S|/a + |T|/b.
    a, b = choose_ab(t, ns, nt)
    rand_recv = ns / a + nt / b
    rand = mk("randjoin", 1,
              peak_workload=1.5 * w / t,
              peak_receive=rand_recv,
              moved=float(b * ns + a * nt),
              note=f"Cor 3, machine matrix {a}x{b}")

    # Broadcast: replicate the small side everywhere, big side never
    # moves; feasible only when the small side fits per-machine memory.
    small = min(ns, nt)
    bcast = CostEstimate(
        algorithm="broadcast", alpha=1,
        k_workload=(w / t) / (w_seq / t),
        k_network=2.0 * small / (n_total / t),
        bytes_shuffled=OBJECT_BYTES * t * small,
        peak_receive=float(small), peak_workload=w / t + small,
        w_seq=w_seq, feasible=small <= mem_budget,
        note=f"small side {small} objects"
             + ("" if small <= mem_budget else " > memory budget"))

    return {"repartition": repart, "statjoin": stat, "randjoin": rand,
            "broadcast": bcast}


# ---------------------------------------------------------------------------
# MoE dispatch: capacity (repartition analogue) vs alpha_k (StatJoin plan)
# vs cluster (the instrumented exchange)
# ---------------------------------------------------------------------------

# Deterministic MoE tie-break: the cheapest machinery that does the job
# -- plain capacity dispatch, then the planned dense layer, then the
# cluster exchange (which buys per-machine buffers with extra rounds).
_DISPATCH_PREFERENCE = ("capacity", "alpha_k", "cluster")


def _greedy_replicas(counts, extra_slots: int):
    """Host mirror of ``plan_slots``' greedy loop: split the expert with
    the largest per-replica load, one extra slot at a time."""
    counts = np.asarray(counts, np.float64)
    rep = np.ones(len(counts), np.int64)
    for _ in range(int(extra_slots)):
        rep[np.argmax(counts / rep)] += 1
    return rep


def moe_dispatch_costs(counts, *, tokens: int, top_k: int,
                       num_experts: int, extra_slots: int, t_machines: int,
                       capacity_factor: float = 1.25,
                       alpha_k_factor: Optional[float] = None
                       ) -> Dict[str, CostEstimate]:
    """Candidate costs for MoE token dispatch from estimated per-expert
    counts (the planner's sketch histogram).

    The workload normalizer is the per-slot mean T*K/n_slots -- per-slot
    ``k_workload`` is the balance metric all three modes report.  The
    ``peak_receive`` column prices each mode's static landing buffer:
    the dense modes materialize every slot's capacity on one (logical)
    machine, the cluster mode only its n_slots/t share -- that factor-t
    smaller buffer is what the two extra rounds buy.
    """
    counts = np.asarray(counts, np.float64)
    e, k, t = int(num_experts), int(top_k), int(t_machines)
    tk = float(max(tokens * k, 1))
    n_slots = e + int(extra_slots)
    if alpha_k_factor is None:
        from ..cluster.capacity import CapacityPolicy
        alpha_k_factor = CapacityPolicy.moe_dispatch().first_factor

    def mk(mode, alpha, peak_slot, peak_receive, moved, drops, note=""):
        mean_slot = tk / (e if mode == "capacity" else n_slots)
        return CostEstimate(
            algorithm=mode, alpha=alpha,
            k_workload=peak_slot / max(mean_slot, 1.0),
            k_network=peak_receive / max(tk / t, 1.0),
            bytes_shuffled=OBJECT_BYTES * moved,
            peak_receive=peak_receive, peak_workload=peak_slot,
            w_seq=tk, feasible=drops <= 0,
            note=note + ("" if drops <= 0
                         else f" [drops ~{int(drops)} assignments]"))

    # capacity: one bucket per expert, hot experts overflow and DROP --
    # the Standard-Repartition-Join failure mode, priced as infeasible
    # whenever the estimated histogram exceeds the capacity.
    cap_e = math.ceil(capacity_factor * tk / e)
    cap_drops = float(np.maximum(counts - cap_e, 0.0).sum())
    capacity = mk("capacity", 1,
                  peak_slot=float(np.minimum(counts, cap_e).max(initial=0.0)),
                  peak_receive=float(e * cap_e),
                  moved=tk, drops=cap_drops,
                  note=f"cap={cap_e}/expert")

    # alpha_k / cluster share the StatJoin plan: greedy replica split of
    # the estimated histogram, Theorem-6 per-slot capacity.
    rep = _greedy_replicas(np.maximum(counts, 1.0), extra_slots)
    slot_peak = float(np.ceil(np.asarray(counts) / rep).max(initial=0.0))
    cap_s = max(1, math.ceil(alpha_k_factor * tk / n_slots))
    ak_drops = float(np.maximum(np.ceil(counts / rep) - cap_s,
                                0.0).sum() * rep.min(initial=1))
    alpha_k = mk("alpha_k", 2,
                 peak_slot=min(slot_peak, float(cap_s)),
                 peak_receive=float(n_slots * cap_s),
                 moved=tk, drops=ak_drops,
                 note=f"Thm 6 cap={cap_s}/slot, "
                      f"max replicas={int(rep.max(initial=1))}")

    s_local = -(-n_slots // t)
    cluster = mk("cluster", 3,
                 peak_slot=min(slot_peak, float(cap_s)),
                 peak_receive=float(s_local * cap_s),
                 moved=2.0 * tk + t * (e + n_slots), drops=ak_drops,
                 note=f"Thm 6 cap={cap_s}/slot, "
                      f"{s_local} slots/machine")
    return {"capacity": capacity, "alpha_k": alpha_k, "cluster": cluster}


def select_dispatch(costs: Dict[str, CostEstimate]) -> CostEstimate:
    """Argmin of the score over feasible dispatch modes; when every mode
    is predicted to drop (capacity exhausted everywhere), alpha_k wins --
    its retry loop recovers where plain capacity dispatch cannot."""
    feasible = [c for c in costs.values() if c.feasible]
    if not feasible:
        return costs["alpha_k"]
    return min(feasible, key=lambda c: (c.score,
                                        _DISPATCH_PREFERENCE.index(
                                            c.algorithm)))


# ---------------------------------------------------------------------------
# exchange topology: flat t-way all_to_all vs two-level staged (AMS-style)
# ---------------------------------------------------------------------------

def _expected_max_pair_load(mean: float, fanin: int) -> float:
    """Expected max of ``fanin`` ~Poisson(mean) per-pair loads.

    The flat exchange splits each receiver's ~m objects over t sender
    pairs; with uniform boundaries the pair loads behave like balls in
    bins, whose max overshoots the mean by ~sqrt(2 mu ln t) + ln t.
    This is the quantity the static per-pair capacity must cover — one
    hot pair overflows the whole tile and triggers a capacity retry.
    """
    if mean <= 0 or fanin <= 1:
        return max(mean, 0.0)
    ln_f = math.log(fanin)
    return mean + math.sqrt(2.0 * mean * ln_f) + ln_f


def _retry_factor(base_factor: float, m: int, fanout: int,
                  growth: float = 2.0, max_retries: int = 3) -> float:
    """The capacity factor the retry loop is *predicted* to settle at:
    grow ``base_factor`` until the per-pair slot count ceil(f*m)/fanout
    covers the expected max pair load (mirrors CapacityPolicy's
    schedule)."""
    need = _expected_max_pair_load(m / fanout, fanout)
    f = base_factor
    for _ in range(max_retries):
        if -(-int(f * m) // fanout) >= need:
            break
        f *= growth
    return f


def exchange_costs(t: int, m: int, *, cap_factor: float,
                   overlap_chunks: int = 2) -> Dict[str, dict]:
    """Predicted peak per-shard receive-buffer objects, flat vs staged.

    Both topologies move the same ~m objects per machine; what differs
    is the *buffer* each one must allocate.  The flat path quantizes
    its capacity per (src, dst) pair — ceil(cap*m)/t slots each — so at
    large t a single expected-hot pair drives the whole factor through
    the retry loop.  The staged path's pair loads are m/t1- and
    m/t2-scale (sqrt t), where the base factor survives.  Values are
    computed with the exact buffer formulas the exchange allocates with
    (the port's core.exchange capacity helpers).
    """
    from ..core.exchange import (flat_receive_capacity,
                                 staged_receive_capacities)
    from ..launch.mesh import factor_shards

    flat_factor = _retry_factor(cap_factor, m, t)
    flat = {
        "topology": "flat",
        "cap_factor": flat_factor,
        "predicted_retries": round(math.log(flat_factor / cap_factor, 2.0)),
        "peak_receive_objects": flat_receive_capacity(m, t, flat_factor),
        "alpha_exchange": 1,
    }
    fs = factor_shards(t)
    if fs is None:
        return {"flat": flat}
    t1, t2 = fs
    f1 = _retry_factor(cap_factor, m, t1)
    f2 = _retry_factor(cap_factor, m, t2)
    staged_factor = max(f1, f2)
    s1, s2 = staged_receive_capacities(m, t1, t2, staged_factor,
                                       overlap_chunks=overlap_chunks)
    staged = {
        "topology": "staged",
        "shape": fs,
        "cap_factor": staged_factor,
        "predicted_retries": round(math.log(staged_factor / cap_factor, 2.0)),
        "peak_receive_objects": max(s1, s2),
        "alpha_exchange": 2,
    }
    return {"flat": flat, "staged": staged}


def choose_exchange(t: int, m: int, *, algorithm: str = "smms", r: int = 2,
                    cap_factor: Optional[float] = None,
                    overlap_chunks: int = 2):
    """Pick the exchange topology for a (t, m) sort: ("flat"|"staged",
    costs-dict).

    The staged path buys its smaller receive buffer with one extra
    synchronized round, so it must win by more than the round charge:
    staged iff ``staged_peak + ROUND_COST_OBJECTS < flat_peak``.
    ``cap_factor=None`` prices the algorithm's own theorem-derived
    starting factor (the one the retry loop actually starts from).
    """
    from ..cluster.capacity import CapacityPolicy

    if cap_factor is None:
        n = t * m
        if algorithm == "terasort":
            cap_factor = CapacityPolicy.terasort(n, t, slack=1.1).first_factor
        else:
            cap_factor = CapacityPolicy.smms(n, t, r).first_factor
    costs = exchange_costs(t, m, cap_factor=cap_factor,
                           overlap_chunks=overlap_chunks)
    if "staged" not in costs:
        return "flat", costs
    staged = costs["staged"]["peak_receive_objects"]
    flat = costs["flat"]["peak_receive_objects"]
    if staged + ROUND_COST_OBJECTS < flat:
        return "staged", costs
    return "flat", costs


def select(costs: Dict[str, CostEstimate]) -> CostEstimate:
    """Deterministic argmin of the score; infeasible candidates excluded."""
    feasible = [c for c in costs.values() if c.feasible]
    if not feasible:
        raise ValueError("no feasible candidate algorithm")
    return min(feasible, key=lambda c: (c.score,
                                        _PREFERENCE.index(c.algorithm)))
