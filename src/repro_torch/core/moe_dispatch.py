"""Cluster-routed MoE expert dispatch: routing run as the paper's skew
join through the instrumented exchange.

Counterpart of ``src/repro/core/moe_dispatch.py``, batched over the
machines a substrate hands the body -- all t on a ``BatchedSubstrate``,
t / world on each rank of a ``ProcessGroupSubstrate`` (the reference's
``lax.axis_index`` is ``tape.axis_index``):

  Round 1   route each machine's tokens (top-k over the router logits),
            all-gather the per-expert and per-slot histograms
            (StatJoin's statistics), and give each assignment its
            global position within its expert and within its slot.
  Round 2   the dispatch exchange: every (slot, pos, x) row travels to
            the machine owning its slot (``exchange_routed_rows``: the
            stable owner sort, the cut, the packed tile, the
            all-to-all) and lands in a (slots a machine, capacity, d)
            buffer.  The slot capacity is Theorem 6's ``2 * T * K /
            n_slots`` from ``CapacityPolicy.moe_dispatch()``, with the
            shared retry on overflow.
  Round 3   each machine's slots through their experts' gated MLPs,
            then the return exchange (``return_routed_rows``): every
            source finds its rows in the tile layout it packed.

Slot s is owned by machine ``s % t``, so a hot expert's replica slots
spread over the machines.  Every collective goes through the
CollectiveTape, so the report's per-machine workload and the per-slot
and per-expert counts are measured in the run, bitwise a host recount.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cluster.capacity import CapacityPolicy, run_with_capacity
from ..cluster.collectives import CollectiveTape
from ..cluster.substrate import resolve_substrate
from ..models.moe import exclusive_positions, expert_ffn, histogram, \
    plan_slots, route
from .exchange import PAD, exchange_routed_rows, return_routed_rows

__all__ = ["MoeDispatchResult", "moe_dispatch_shard", "cluster_moe_dispatch"]

PHASES = ("round1 route stats", "round2 dispatch", "round3 experts")


class MoeDispatchResult(NamedTuple):
    y: torch.Tensor              # (t, m, d) combined expert outputs
    dropped: torch.Tensor        # global dropped assignments (int32 scalar)
    kept: torch.Tensor           # (t,) assignments processed a machine
    slot_counts: torch.Tensor    # (NS,) global assignments a slot
    expert_counts: torch.Tensor  # (E,) global assignments an expert


def _global_positions(ids: torch.Tensor, n: int, tape: CollectiveTape):
    """(rows, L) ids in [0, n) -> (global totals (n,), each entry's
    position among the entries of its value over the machines in
    order): the machines' histograms all-gathered, their exclusive
    prefix over the machines added to the local exclusive position."""
    counts = histogram(ids, n)                              # (rows, n)
    counts_all = tape.all_gather(counts, count=n)           # (t, n)
    off = torch.cumsum(counts_all, dim=0, dtype=torch.int32) - counts_all
    off = off[tape.axis_index(ids.shape[0], ids.device)]    # my machines'
    pos = exclusive_positions(ids, n) + torch.gather(off, 1, ids.long())
    return counts_all.sum(dim=0, dtype=torch.int32), pos


def moe_dispatch_shard(x: torch.Tensor, *, router: torch.Tensor,
                       w_gate: torch.Tensor, w_up: torch.Tensor,
                       w_down: torch.Tensor, slot2expert: torch.Tensor,
                       slot_table: torch.Tensor, replicas: torch.Tensor,
                       t: int, num_experts: int, top_k: int,
                       extra_slots: int, capacity_slot: int, cap_pair: int,
                       act: str = "swiglu",
                       tape: Optional[CollectiveTape] = None
                       ) -> MoeDispatchResult:
    """The dispatch body of the machines this tape holds.  x: (rows, m,
    d) tokens, rows = t on a batch, t / world on a rank of a group.

    ``slot2expert`` / ``slot_table`` / ``replicas`` are the StatJoin
    slot plan (:func:`repro_torch.models.moe.plan_slots`) on x's
    device; ``capacity_slot`` bounds the assignments a slot takes,
    ``cap_pair`` the rows a (source, destination) tile carries.  The
    router and expert weights are the same on every machine and every
    rank (each rank holds them whole), so they come in as keywords; a
    machine's own ids come from ``tape.axis_index``.  The global totals
    and the dropped count are whole on every machine
    (``tape.replicated``).
    """
    tape = tape if tape is not None else CollectiveTape()
    rows, m, d = x.shape
    e, k = num_experts, top_k
    n_slots = e + extra_slots
    s_local = -(-n_slots // t)          # slots a machine (round-robin)
    dev = x.device
    me = tape.axis_index(rows, dev)     # global machine ids
    loc = torch.arange(rows, device=dev)

    with tape.phase(PHASES[0]):
        gate_vals, ids = route(x, router, k)                # (rows, m, K)
        gates = torch.softmax(gate_vals, dim=-1).reshape(rows, m * k)
        flat_ids = ids.reshape(rows, m * k)
        tot_e, pos_in_e = _global_positions(flat_ids, e, tape)
        rho = pos_in_e % replicas[flat_ids.long()]      # StatJoin even split
        slot = slot_table[flat_ids.long(), rho.clamp(0, extra_slots).long()]
        tot_s, pos = _global_positions(slot, n_slots, tape)

    with tape.phase(PHASES[1]):
        owner = slot % t
        rows_k = x.float()[:, :, None].expand(rows, m, k, d).reshape(
            rows, m * k, d)
        payload = torch.cat([slot.float()[..., None], pos.float()[..., None],
                             rows_k], dim=2)
        routed = exchange_routed_rows(owner, payload, t=t, cap_pair=cap_pair,
                                      tape=tape)
        valid = routed.recv_keys < PAD                  # (rows, t, cap_pair)
        slot_r = routed.recv_payload[..., 0].to(torch.int32)
        pos_r = routed.recv_payload[..., 1].to(torch.int32)
        keep_r = valid & (pos_r < capacity_slot)
        # slot s lives at local index s // t on machine s % t
        tgt = torch.where(keep_r, (slot_r // t) * capacity_slot + pos_r,
                          s_local * capacity_slot)      # trash row last
        buf_rows = s_local * capacity_slot + 1
        flat_tgt = (loc[:, None, None] * buf_rows + tgt.long()).reshape(-1)
        buf = torch.zeros((rows * buf_rows, d), dtype=torch.float32,
                          device=dev)
        buf.index_add_(0, flat_tgt, routed.recv_payload[..., 2:].reshape(-1, d))
        buf = buf.reshape(rows, buf_rows, d)[:, :-1].reshape(
            rows, s_local, capacity_slot, d)
        recv_drop = (valid & ~keep_r).sum(dim=(1, 2))
        dropped = tape.psum(routed.local_drop + recv_drop).to(torch.int32)
        kept = keep_r.sum(dim=(1, 2), dtype=torch.int32)

    with tape.phase(PHASES[2]):
        my_slots = torch.arange(s_local, device=dev)[None] * t + me[:, None]
        exp_ids = slot2expert[my_slots.clamp(0, n_slots - 1)].long()
        # one machine's slots at a time: the gathered weights of all the
        # machines' slots would be rows times one machine's
        out_buf = torch.stack([
            expert_ffn(buf[i], w_gate[exp_ids[i]], w_up[exp_ids[i]],
                       w_down[exp_ids[i]], act) for i in range(rows)])
        out_flat = torch.cat([out_buf.reshape(rows, -1, d),
                              out_buf.new_zeros((rows, 1, d))], dim=1)
        back = out_flat[loc[:, None, None], tgt.long()]  # (rows, t, cap, d)
        valid_per_src = valid.sum(dim=2)                # (rows, t_src)
        sent_back = valid_per_src.sum(dim=1) - valid_per_src[loc, me]
        # the rows a machine sent that landed (the pair capacity clips
        # them) come back to it: the return hop's received count
        recv_back = routed.lens.clamp(max=cap_pair).sum(dim=1)
        y_rows = return_routed_rows(back, routed, tape=tape, sent=sent_back,
                                    received=recv_back)  # (rows, m*K, d)
        w = gates * (pos < capacity_slot).to(gates.dtype)
        y = (y_rows * w[..., None]).reshape(rows, m, k, d).sum(dim=2)
    return MoeDispatchResult(y.to(x.dtype), tape.replicated(dropped), kept,
                             tape.replicated(tot_s), tape.replicated(tot_e))


def cluster_moe_dispatch(params, x: torch.Tensor, cfg, *, t_machines: int,
                         counts=None, substrate=None,
                         policy: Optional[CapacityPolicy] = None,
                         act: str = "swiglu"):
    """Run one MoE layer with cluster-routed dispatch on x's device.

    x: (..., d) tokens; the flattened token count must divide over
    ``t_machines``.  ``params``: router (d, E) and the expert weights,
    on x's device.  ``counts``: (E,) estimated assignments an expert
    (the planner's sketch, ``planner.expert_counts_estimate``) driving
    the greedy ``plan_slots``; None plans uniform replicas.  ``policy``
    defaults to ``CapacityPolicy.moe_dispatch()`` (Theorem 6); the slot
    and pair capacities grow together through the retry loop.  Returns
    ``(y, report)``: y shaped like x, and an AlphaKReport with
    ``slot_workload`` / ``expert_workload`` / ``k_slot`` / ``k_expert``
    / ``capacity`` / ``cap_factor`` / ``capacity_attempts`` /
    ``slot2expert`` / ``slot_replicas``.
    """
    orig_shape = x.shape
    d = int(x.shape[-1])
    xt = x.reshape(-1, d)
    tt = int(xt.shape[0])
    t = int(t_machines)
    if tt % t:
        raise ValueError(f"cluster moe_dispatch needs the token count {tt} "
                         f"to divide over t_machines={t}")
    m = tt // t
    e, k = int(cfg.num_experts), int(cfg.top_k)
    n_slots = e + int(cfg.extra_slots)
    if counts is None:
        counts = np.full((e,), max(1, tt * k // e), dtype=np.int64)
    # the plan is made on the host from host counts, then moved over
    s2e, rep, table = plan_slots(
        torch.from_numpy(np.asarray(counts).astype(np.int32)), e,
        int(cfg.extra_slots))
    substrate = resolve_substrate(substrate, t)
    if substrate.t != t or len(substrate.axes) != 1:
        raise ValueError(f"substrate axes {substrate.axes} do not match "
                         f"t_machines={t} (cluster dispatch is flat)")
    if policy is None:
        policy = CapacityPolicy.moe_dispatch()
    dev = x.device
    plan = dict(slot2expert=s2e.to(dev), slot_table=table.to(dev),
                replicas=rep.to(dev))

    def attempt(factor):
        capacity_slot = max(1, math.ceil(factor * tt * k / n_slots))
        cap_pair = max(1, math.ceil(factor * m * k / t))
        body = functools.partial(
            moe_dispatch_shard, router=params["router"],
            w_gate=params["w_gate"], w_up=params["w_up"],
            w_down=params["w_down"], **plan, t=t, num_experts=e, top_k=k,
            extra_slots=int(cfg.extra_slots), capacity_slot=capacity_slot,
            cap_pair=cap_pair, act=act)
        res, tape = substrate.run(body, xt.reshape(t, m, d))
        return (res, tape, capacity_slot), int(res.dropped)

    (res, tape, capacity_slot), factor, attempts = run_with_capacity(
        attempt, policy)

    report = tape.report(algorithm="moe[cluster]", t=t, n_in=tt * k,
                         n_out=tt * k, workload=res.kept.cpu().numpy())
    report.dispatch_mode = "cluster"
    report.slot_workload = res.slot_counts.cpu().numpy()
    report.expert_workload = res.expert_counts.cpu().numpy()
    report.k_slot = float(report.slot_workload.max()
                          / max(1.0, tt * k / n_slots))
    report.k_expert = float(report.expert_workload.max()
                            / max(1.0, tt * k / e))
    report.capacity = int(capacity_slot)
    report.cap_factor = factor
    report.capacity_attempts = attempts
    report.total_dropped = 0
    report.slot2expert = s2e.numpy()
    report.slot_replicas = rep.numpy()
    return res.y.reshape(orig_shape), report
