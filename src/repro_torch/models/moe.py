"""Mixture-of-Experts with (alpha, k)-balanced dispatch.

Counterpart of ``src/repro/models/moe.py``.  Token->expert routing is
the skew-join problem: tokens are S-tuples keyed by expert id, the
expert weights the T side, and a hot expert is Join Product Skew.  Two
dense dispatch modes (the cluster-routed ones are
``repro_torch.cluster.moe_dispatch``):

* ``capacity`` -- top-k and a capacity of ``capacity_factor * T * K /
  E`` a expert: a hot expert overflows its one bucket and drops
  assignments (the Standard Repartition Join's last reducer);
* ``alpha_k`` -- StatJoin's plan on the router histogram:
  :func:`plan_slots` hands the R extra slots out greedily to the expert
  with the largest per-replica load, assignment i of expert e goes to
  replica ``pos_i mod r_e`` (the even split) or a random replica
  (RandJoin's draw), and each slot holds Theorem 6's ``2 * T * K /
  n_slots`` (``CapacityPolicy.moe_dispatch``).

The arithmetic follows the reference's order and dtypes: the router
product and the softmax in float32, the buffers in the activations'
dtype, the expert products in the promoted dtype of the buffer and the
weights (as ``jnp.einsum`` promotes), the activation in float32.
Positions within an expert and a slot are exclusive int32 prefix sums
of one-hots (the reference's ``associative_scan``, ROADMAP C2); the
scatter into the slot buffer adds onto zeros with a trash row last,
where every real target is unique, so it is exact in any order.
``lax.top_k`` keeps the lower index first on ties: a stable descending
sort does the same.  There is no mesh, so the reference's
``shard_slots`` / ``shard_groups`` constraints have no counterpart;
``groups`` stays, since it changes the capacity.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..sharding.parallel import all_reduce_, copy_to
from .layers import init_dense

__all__ = ["MoEStats", "init_moe", "plan_slots", "route", "moe_layer",
           "histogram", "exclusive_positions", "expert_ffn"]


class MoEStats(NamedTuple):
    """The reference's four fields, then each assignment's expert and
    whether it was kept (x's token order)."""
    dropped: torch.Tensor         # assignments dropped (int scalar)
    max_slot_load: torch.Tensor   # most assignments landing on one slot
    mean_slot_load: torch.Tensor  # float32
    slot_load: torch.Tensor       # (NS,) int32 assignments a slot
    ids: torch.Tensor             # (..., K) int32 routed experts
    keep: torch.Tensor            # (..., K) bool: not dropped


def init_moe(generator: torch.Generator, d: int, cfg: MoEConfig, dtype,
             device):
    """Router (float32) and the E experts' gated-MLP weights (``dtype``),
    drawn from ``generator`` on ``device``."""
    e, ff = cfg.num_experts, cfg.d_ff_expert
    return {
        "router": init_dense(generator, (d, e), torch.float32, device),
        "w_gate": init_dense(generator, (e, d, ff), dtype, device),
        "w_up": init_dense(generator, (e, d, ff), dtype, device),
        "w_down": init_dense(generator, (e, ff, d), dtype, device),
    }


def plan_slots(counts: torch.Tensor, num_experts: int, extra_slots: int):
    """StatJoin planner: assign R extra slots to experts greedily.

    counts: (E,) token counts, on any device (the plan is made there).
    Returns (slot2expert (E+R,), replicas (E,), slot_table (E, R+1)),
    int32: slot s serves expert slot2expert[s], expert e owns the slots
    slot_table[e, :replicas[e]].

    The reference's greedy loop gives extra slot E+i to the expert of
    the largest per-replica load counts[e] / r_e (float32; the lowest
    index on a tie, as ``jnp.argmax``).  Expert e's loads before its
    j-th extra slot, counts[e] / j, fall with j, so the loop takes the R
    largest of the E x R loads counts[e] / j in falling order, equal
    loads by expert, then j: one stable descending sort of them in
    (e, j) order, with no loop of R steps.
    """
    e, r = num_experts, extra_slots
    dev = counts.device
    experts = torch.arange(e, dtype=torch.int32, device=dev)
    j = torch.arange(1, r + 1, dtype=torch.float32, device=dev)
    loads = (counts.float()[:, None] / j[None, :]).reshape(-1)   # (E * R,)
    picks = torch.sort(loads, descending=True, stable=True).indices[:r]
    hot, nth = (picks // r).to(torch.int32), picks % r + 1
    slot2expert = torch.cat([experts, hot])
    replicas = 1 + histogram(hot, e)
    slot_table = torch.zeros((e, r + 1), dtype=torch.int32, device=dev)
    slot_table[:, 0] = experts
    slot_table[hot.long(), nth] = e + torch.arange(r, dtype=torch.int32,
                                                   device=dev)
    return slot2expert, replicas, slot_table


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """The router's top-k: (gate values, expert ids) of ``x @ router`` in
    float32, the larger logits first and the lower expert first on a
    tie (``lax.top_k``).  x: (..., d); returns (..., k) each, ids int32."""
    logits = x.float() @ router
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def histogram(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) int32 counts of the values in [0, n) along the last axis
    of ``ids``, with no read back to the host (``torch.bincount`` on a
    card reads the maximum back)."""
    idx = ids.long()
    out = torch.zeros(ids.shape[:-1] + (n,), dtype=torch.int32,
                      device=ids.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))


def exclusive_positions(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry's position among the earlier entries of its value
    along the last axis: the exclusive int32 prefix sum of the one-hots
    over [0, n), read at the entry's own value.  The one-hots are laid
    out (..., n, L), so the scan runs along the innermost axis (torch's
    scan along an outer axis runs one thread a column on a card), and
    come from a comparison (``F.one_hot`` reads its operand's range back
    to the host on a card)."""
    onehot = (torch.arange(n, device=ids.device)[:, None]
              == ids[..., None, :]).to(torch.int32)
    prefix = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    return torch.gather(prefix, -2, ids.long()[..., None, :])[..., 0, :]


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "geglu":
        return F.gelu(g.float(), approximate="tanh")
    return F.silu(g.float())


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """Batched gated MLP: buf (S, C, d) rows through slot s's weights
    (S, d, ff), (S, ff, d).  The products run in the promoted dtype of
    the rows and the weights, as the reference's einsums; the
    activation in float32, cast back to the rows' dtype."""
    dt = torch.promote_types(buf.dtype, w_gate.dtype)
    g = torch.bmm(buf.to(dt), w_gate.to(dt))
    u = torch.bmm(buf.to(dt), w_up.to(dt))
    h = _act(g, act).to(buf.dtype) * u
    dt2 = torch.promote_types(h.dtype, w_down.dtype)
    return torch.bmm(h.to(dt2), w_down.to(dt2))


def moe_layer(params, x: torch.Tensor, cfg: MoEConfig, act: str = "swiglu",
              groups: int = 1, rng: Optional[torch.Generator] = None,
              draws: Optional[torch.Tensor] = None, *, par=None,
              total_groups: Optional[int] = None, count_groups=()):
    """x: (..., d) -> ((..., d), MoEStats), dense dispatch.

    ``groups``: tokens are dispatched in ``groups`` groups (the
    reference's data shards): positions in a slot count within a group,
    and the ``alpha_k`` capacity is split per group with 25% slack.  A
    count that does not divide the tokens warns and runs one group.

    On a mesh (``par``, ``sharding.parallel.Par``) x holds this rank's
    ``groups`` of the ``total_groups`` groups the reference dispatches
    (the batch axes in ``count_groups`` split the rest), entered into
    the 'model' region; the routing histogram is summed over
    ``count_groups``, so the slot plan is the whole batch's.  The
    experts are split over 'model' by the rules: whole experts (EP,
    where 'model' divides E: this rank runs its own experts' slots and
    every extra slot that lands on one of them) or each expert's d_ff
    (TP).  Either way y is this rank's partial sum, for the caller to
    reduce.
    ``replica_choice="random"`` takes its (groups, T/groups * K) draws
    in [0, 2^30) as ``draws`` (how the tests hand in the reference's
    ``jax.random.randint``), or draws them from the ``rng`` generator.
    """
    if cfg.dispatch not in ("capacity", "alpha_k"):
        raise ValueError(
            f"moe_layer implements the dense 'capacity'/'alpha_k' dispatch "
            f"modes only, got {cfg.dispatch!r}; route "
            f"dispatch='cluster'/'auto' through repro_torch.cluster."
            f"moe_dispatch")
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    tt = xt.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    dev = x.device
    if total_groups is None:
        total_groups = groups
    router = params["router"]
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    ep = None
    if par is not None:
        router = copy_to(par.w(router), par.group)
        w_gate, w_up, w_down = (par.w(w) for w in (w_gate, w_up, w_down))
        if par.on and e % par.m == 0:
            ep = (par.rank * (e // par.m), e // par.m)
    if tt % groups:
        warnings.warn(
            f"groups={groups} does not divide the token count {tt}; "
            "falling back to a single dispatch group (flat scatter)",
            stacklevel=2)
        groups = 1
    tg = tt // groups

    gate_vals, ids = route(xt, router, k)                 # (T, K)
    gates = torch.softmax(gate_vals, dim=-1)
    flat_ids = ids.reshape(groups, tg * k)

    if cfg.dispatch == "alpha_k":
        n_slots = e + cfg.extra_slots
        counts = histogram(flat_ids.reshape(-1), e)
        for g in count_groups:          # the whole batch's histogram
            all_reduce_(counts, g)
        slot2expert, replicas, slot_table = plan_slots(counts, e,
                                                       cfg.extra_slots)
        pos_in_e = exclusive_positions(flat_ids, e)        # (G, Tg*K)
        r_e = replicas[flat_ids.long()]
        if cfg.replica_choice == "random":
            if draws is None:
                if rng is None:
                    raise ValueError(
                        "replica_choice='random' needs an rng generator or "
                        "the draws: pass rng= or draws= to moe_layer (the "
                        "RandJoin tuple-to-interval draw must not silently "
                        "degrade to the even split)")
                draws = torch.randint(0, 1 << 30, flat_ids.shape,
                                      generator=rng, dtype=torch.int32,
                                      device=dev)
            rho = draws.to(device=dev, dtype=torch.int32) % r_e
        else:                                          # StatJoin even split
            rho = pos_in_e % r_e
        slot = slot_table[flat_ids.long(),
                          rho.clamp(0, cfg.extra_slots).long()]
        if cfg.alpha_k_cap is None:
            from ..cluster.capacity import CapacityPolicy
            cap_mult = CapacityPolicy.moe_dispatch().first_factor
        else:
            cap_mult = cfg.alpha_k_cap
        capacity = max(1, math.ceil(cap_mult * tt * k / n_slots
                                    / groups
                                    * (1.25 if total_groups > 1 else 1.0)))
    else:
        n_slots = e
        slot = flat_ids
        slot2expert = torch.arange(e, dtype=torch.int32, device=dev)
        capacity = max(1, math.ceil(cfg.capacity_factor * tt * k / e
                                    / groups))

    slot_counts = histogram(slot.reshape(-1), n_slots)
    pos = exclusive_positions(slot, n_slots)               # (G, Tg*K)
    keep = pos < capacity
    dropped = (~keep).sum()

    # group-local scatter onto zeros, the trash row last in each group
    rows = n_slots * capacity + 1
    target = torch.where(keep, slot * capacity + pos, n_slots * capacity)
    src = xt.reshape(groups, tg, 1, d).expand(groups, tg, k, d)
    flat_target = (torch.arange(groups, device=dev)[:, None] * rows
                   + target.long()).reshape(-1)
    buf = torch.zeros((groups * rows, d), dtype=xt.dtype, device=dev)
    buf.index_add_(0, flat_target, src.reshape(-1, d))
    buf = buf.reshape(groups, rows, d)[:, :-1]
    # group-major -> slot-major: (NS, G * C, d)
    buf = buf.reshape(groups, n_slots, capacity, d).transpose(0, 1)
    buf = buf.reshape(n_slots, groups * capacity, d)

    s2e = slot2expert.long()
    if ep is None:
        out_buf = expert_ffn(buf, w_gate[s2e], w_up[s2e], w_down[s2e], act)
    else:
        # this rank's experts' own slots, and every extra slot masked by
        # whether its expert is one of them: static shapes
        lo, el = ep
        idx = torch.cat([torch.arange(lo, lo + el, device=dev),
                         torch.arange(e, n_slots, device=dev)])
        sel = s2e[idx]
        mine = (sel >= lo) & (sel < lo + el)
        wi = (sel - lo).clamp(0, el - 1)
        part = expert_ffn(buf[idx], w_gate[wi], w_up[wi], w_down[wi], act)
        part = part * mine[:, None, None].to(part.dtype)
        out_buf = torch.zeros((n_slots,) + tuple(part.shape[1:]),
                              dtype=part.dtype, device=dev
                              ).index_copy(0, idx, part)
    out_buf = out_buf.reshape(n_slots, groups, capacity, d).transpose(0, 1)
    out_buf = out_buf.reshape(groups, n_slots * capacity, d)
    safe = torch.where(keep, slot * capacity + pos, 0).long()
    y = torch.gather(out_buf, 1, safe[..., None].expand(-1, -1, d))
    y = y * (gates.reshape(groups, tg * k) * keep).to(y.dtype)[..., None]
    y = y.reshape(groups, tg, k, d).sum(dim=2).reshape(tt, d)
    stats = MoEStats(dropped=dropped, max_slot_load=slot_counts.max(),
                     mean_slot_load=slot_counts.float().mean(),
                     slot_load=slot_counts,
                     ids=ids.reshape(*orig_shape[:-1], k),
                     keep=keep.reshape(*orig_shape[:-1], k))
    return y.reshape(*orig_shape[:-1], d), stats
