"""The cluster front door of the port.

    from repro_torch import cluster
    (keys, values), report = cluster.sort(x, algorithm="smms", values=v)
    (keys, _), report = cluster.sort(x, algorithm="terasort", seed=0)
    out, report = cluster.join(sk, sr, tk, tr, algorithm="statjoin",
                               t_machines=8)
    y, report = cluster.moe_dispatch(params, x, cfg, mode="cluster",
                                     t_machines=8)

Counterpart of ``src/repro/cluster/api.py`` (``sort`` :86, ``join``
:195, ``moe_dispatch`` :339): SMMS and Terasort, with or without
values, over the flat or the staged exchange (``exchange="flat" |
"staged" | "auto"``), the joins -- StatJoin (the paper's §4.3),
RandJoin (§4.2) and the baselines, repartition and broadcast -- and one
MoE layer with its token->expert dispatch run as a skew join.  ``algorithm="auto"`` hands the
choice to the planner (``repro_torch.planner``): a sketch round
profiles the input, the theorem cost model scores every candidate, and
the call dispatches to the winner -- bitwise the call that names it.
The report then carries the plan (``report.query_plan``), the predicted
alpha and k beside the measured ones, and the sketch round's phases
(``report.sketch_phases``); a repeated query over the same data hits
the plan cache and runs no sketch.

Terasort and RandJoin draw random numbers: from ``seed`` by a
``torch.Generator`` on the run's device, or the caller's own draws
(``uniforms=`` for Terasort's Algorithm S, ``assignments=`` for
RandJoin), which is how the tests hand the port the reference's
``jax.random`` draws.

Every algorithm runs on a substrate: ``substrate=`` takes a
``BatchedSubstrate`` (t machines on one device) or a
``ProcessGroupSubstrate`` (t machines over the ranks of a
``torch.distributed`` group: every rank makes the same call with the
whole operands and gets the whole result), a provider -- any callable
mapping an axis spec to one, a ``SubstratePool`` above all -- or None,
the process-wide pool (``substrate.default_pool``).  ``algorithm="auto"``
and ``moe_dispatch``'s ``cluster`` / ``auto`` modes run their sketch
round (and the dispatch) on the substrate too, on a process group as
on a batch; the ranks agree on a plan-cache hit before they sketch.
A provider is called with the axes
each algorithm needs: ``(t,)`` for the flat sorts, the sketch and the
1D joins, the staged grid's two named axes, RandJoin's ``(("a", a),
("b", b))``; the query engine hands its pool in this way.

The run happens on the card unless the caller asks otherwise:
``device=None`` means ``"cuda"``, and raises when no card is present --
it never falls back to the CPU.  ``device="cpu"`` runs the kernels'
plain versions (what the tests do).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import trace as obs_trace
from .capacity import CapacityPolicy, run_with_capacity

__all__ = ["sort", "join", "moe_dispatch", "SORT_ALGORITHMS",
           "JOIN_ALGORITHMS", "MOE_DISPATCH_MODES", "AUTO", "resolve_device"]

SORT_ALGORITHMS = ("smms", "terasort")
JOIN_ALGORITHMS = ("statjoin", "randjoin", "repartition", "broadcast")
MOE_DISPATCH_MODES = ("capacity", "alpha_k", "cluster")
AUTO = "auto"


# The host dtypes JAX's default 32-bit mode narrows (the reference's
# front door reads a numpy array through jnp.asarray): float64 and
# int64 arrays arrive as float32 and int32.
_X32 = {np.dtype(np.float64): np.dtype(np.float32),
        np.dtype(np.int64): np.dtype(np.int32)}


def _x32(a):
    """``a`` as the reference's front door sees it: a host array with
    float64 and int64 narrowed to float32 and int32 (a copy only then);
    a tensor as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return a.astype(_X32[a.dtype]) if a.dtype in _X32 else a


def _as_tensor(a) -> torch.Tensor:
    """A tensor of ``a``; a numpy array (or a read-only view of one) is
    copied first."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _to_device(a, dev: torch.device) -> torch.Tensor:
    """``a`` as the reference's front door sees it (:func:`_x32`), on
    ``dev``; a host array's copy to the card blocks the host (a
    ``sync:input`` span)."""
    a = torch.as_tensor(_x32(a))
    with obs_trace.sync("input", not a.is_cuda and dev.type == "cuda"):
        return a.to(dev)


def _attach_plan(report, plan, sketch_phases) -> None:
    """Put the planner's decision and prediction on an AlphaKReport."""
    report.query_plan = plan
    report.predicted_alpha = plan.predicted.alpha
    report.predicted_k = plan.predicted.k_workload
    report.predicted_k_network = plan.predicted.k_network
    report.sketch_phases = list(sketch_phases)


def sort(x, *, algorithm: str = "smms", r: int = 2, seed: int = 0,
         cap_factor: Optional[float] = None, policy=None, values=None,
         exchange: str = "flat", overlap_chunks: int = 2, uniforms=None,
         backend: str = "static", substrate=None, device=None):
    """Distributed sort of x: (t, m), one row per machine.

    x: a numpy array or a tensor (float32, bfloat16 or int32 keys; a
    float64 or int64 numpy array is narrowed to float32 or int32, as
    the reference's front door narrows it); values: None, or (t, m,
    ...) payload aligned with x, narrowed the same way.  ``r`` is
    SMMS's sampling ratio; ``seed`` and
    ``uniforms`` ((t, m) float32, one draw per object) are Terasort's
    Algorithm-S draws.  Returns ``((keys, values), report)``: the n
    sorted keys as a tensor on the run's device, the values in the
    keys' stable order (or None), and the AlphaKReport, as the
    reference's front door returns them.

    ``algorithm="auto"`` lets the planner sketch the rows and pick (the
    dispatched call is bitwise the call naming the winner).
    ``exchange``: "flat" (one t-way all-to-all), "staged" (two
    ~sqrt(t)-way hops over the t1 x t2 factorization of t, stage 2 in
    ``overlap_chunks`` slices; one more round, the same keys; a t that
    does not factor warns and runs flat) or "auto" (the planner's
    topology model); ``report.exchange_topology`` says which ran.
    ``backend``: Round 3's ``"static"`` tiles or its ``"ragged"``
    exact-size segments (a ``ProcessGroupSubstrate``'s only, flat only;
    the same keys, values and report, nothing dropped).
    ``substrate``: see the module docstring (a 2-axis substrate runs
    staged over its own grid).
    """
    with obs_trace.span("cluster.sort") as sp:
        t, m = _sort_shape(x, values, algorithm, exchange)
        dev = resolve_device(device)
        xt = _to_device(x, dev).contiguous()
        vt = None if values is None else _to_device(values, dev)
        if sp is not None:
            sp.attrs.update(algorithm=algorithm, t=t, m=m, payload_bytes=(
                0 if vt is None else vt.element_size() * vt[0, 0].numel()))
        if algorithm != AUTO:
            return _sort(xt, t, m, algorithm=algorithm, r=r, seed=seed,
                         cap_factor=cap_factor, policy=policy, values=vt,
                         exchange=exchange, overlap_chunks=overlap_chunks,
                         uniforms=uniforms, backend=backend,
                         substrate=substrate, device=dev)
        from ..planner import plan_sort_query
        # the fingerprint reads the caller's host array; the sketch the
        # rows already on the device
        plan, sketch_phases = plan_sort_query(x, t=t, r=r, device=dev,
                                              x_device=xt,
                                              substrate=substrate)
        out, report = _sort(
            xt, t, m, algorithm=plan.algorithm, r=r, seed=seed,
            cap_factor=cap_factor, policy=policy, values=vt,
            exchange=plan.exchange if exchange == AUTO else exchange,
            overlap_chunks=overlap_chunks, uniforms=uniforms,
            backend=backend, substrate=substrate, device=dev)
        _attach_plan(report, plan, sketch_phases)
        return out, report


def _sort_shape(x, values, algorithm: str, exchange: str):
    """(t, m) of a sort's rows, once its arguments are checked."""
    if exchange not in ("flat", "staged", AUTO):
        raise ValueError(f"unknown exchange topology {exchange!r}; "
                         f"expected 'flat', 'staged' or '{AUTO}'")
    if algorithm != AUTO and algorithm not in SORT_ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}; "
                         f"expected one of {SORT_ALGORITHMS + (AUTO,)}")
    if np.ndim(x) != 2:
        raise ValueError(
            f"sort expects x of shape (t, m) -- one row per machine -- got "
            f"shape {tuple(np.shape(x))}; reshape with x.reshape(t, -1)")
    if values is not None and tuple(np.shape(values)[:2]) != np.shape(x):
        raise ValueError(f"values of shape {tuple(np.shape(values))} do not "
                         f"align with x of shape {tuple(np.shape(x))}")
    return tuple(int(d) for d in np.shape(x))


def _sort(xt: torch.Tensor, t: int, m: int, *, algorithm: str, r, seed,
          cap_factor, policy, values, exchange, overlap_chunks, uniforms,
          backend, substrate, device):
    """:func:`sort` past its checks, on the rows on the device, by the
    named algorithm (an ``exchange="auto"`` resolved here)."""
    dev, vt = device, values
    if exchange == AUTO:
        from ..planner import choose_exchange
        exchange, _ = choose_exchange(t, m, algorithm=algorithm, r=r,
                                      cap_factor=cap_factor,
                                      overlap_chunks=overlap_chunks)
    if algorithm == "terasort":
        from ..core.terasort import terasort_sort
        ut = None if uniforms is None else _as_tensor(uniforms).to(dev)
        return terasort_sort(xt, seed=seed, cap_factor=cap_factor,
                             policy=policy, values=vt, uniforms=ut,
                             exchange=exchange,
                             overlap_chunks=overlap_chunks, backend=backend,
                             substrate=substrate)
    from ..core.smms import smms_sort
    return smms_sort(xt, r=r, cap_factor=cap_factor, policy=policy,
                     values=vt, exchange=exchange,
                     overlap_chunks=overlap_chunks, backend=backend,
                     substrate=substrate)


def join(s_keys, s_rows, t_keys, t_rows, *, algorithm: str = "statjoin",
         t_machines: int, out_capacity: Optional[int] = None, seed: int = 0,
         in_cap_factor: float = 4.0, out_cap_factor: float = 1.05,
         ab: Optional[Tuple[int, int]] = None, stats=None,
         small_side: Optional[str] = None, assignments=None,
         mem_budget: Optional[int] = None, substrate=None, device=None):
    """Distributed equi-join of S and T.  Returns (JoinOutput, report).

    Keys and row ids are host arrays (int32 keys below MASKED_KEY);
    StatJoin's planning and routing, and the baselines' hashing and
    dealing, run on the host in numpy, as in the reference, and the
    local joins on ``device``, all t machines at once.  RandJoin routes
    on the card.

    ``out_capacity`` defaults, from exact statistics (W result pairs),
    to W + 64 for repartition -- which can pin the whole result on one
    machine, the imbalance it exists to show -- and to
    max(64, ceil(2 out_cap_factor W / t)) for RandJoin and broadcast,
    which retry with doubled capacity up to three times when results
    drop (RandJoin's route capacities, ``in_cap_factor`` times each
    machine's fair share of a line, grow with it).  StatJoin sizes its
    own by Theorem 6.  RandJoin's machine matrix is ``ab=(a, b)`` or
    the §4.2.1 choice; its draws come from ``seed``, or are
    ``assignments=(rows, columns)``, (t, ms) and (t, mt) int32.

    ``algorithm="auto"`` sketches both tables in one round, scores the
    four algorithms by the theorem cost model and dispatches to the
    winner; ``mem_budget`` (objects) caps broadcast's small side there.
    ``substrate``: see the module docstring.
    """
    dev = resolve_device(device)
    if algorithm == AUTO:
        from ..planner import plan_join_query
        plan, sketch_phases = plan_join_query(
            s_keys, t_keys, t_machines=t_machines, mem_budget=mem_budget,
            device=dev, substrate=substrate)
        out, report = join(
            s_keys, s_rows, t_keys, t_rows, algorithm=plan.algorithm,
            t_machines=t_machines, out_capacity=out_capacity, seed=seed,
            in_cap_factor=in_cap_factor, out_cap_factor=out_cap_factor,
            ab=ab, stats=stats, small_side=small_side,
            assignments=assignments, mem_budget=mem_budget,
            substrate=substrate, device=dev)
        _attach_plan(report, plan, sketch_phases)
        return out, report
    if algorithm not in JOIN_ALGORITHMS:
        raise ValueError(f"unknown join algorithm {algorithm!r}; "
                         f"expected one of {JOIN_ALGORITHMS + (AUTO,)}")
    if algorithm == "statjoin":
        from ..core.statjoin import statjoin
        return statjoin(s_keys, s_rows, t_keys, t_rows, t_machines,
                        out_cap_factor=out_cap_factor, stats=stats,
                        out_capacity=out_capacity, device=dev,
                        substrate=substrate)

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
                                out_capacity, device=dev,
                                substrate=substrate)
    if algorithm == "randjoin":
        from ..core.randjoin import choose_ab, randjoin
        a, b = ab if ab is not None else choose_ab(
            t_machines, int(np.shape(s_keys)[0]), int(np.shape(t_keys)[0]))

        def attempt_randjoin(cap):
            out, rep = randjoin(s_keys, s_rows, t_keys, t_rows, t_machines,
                                int(cap), seed=seed,
                                in_cap_factor=in_cap_factor
                                * (cap / out_capacity),
                                ab=(a, b), assignments=assignments,
                                device=dev, substrate=substrate)
            return (out, rep), int(out.dropped.max())

        if not defaulted_capacity:
            return attempt_randjoin(out_capacity)[0]
        (out, rep), factor, attempts = run_with_capacity(
            attempt_randjoin, CapacityPolicy.fixed(out_capacity,
                                                   max_retries=3))
        rep.cap_factor = factor
        rep.capacity_attempts = attempts
        return out, rep

    from ..core.broadcastjoin import broadcast_join

    def attempt(cap):
        out, rep = broadcast_join(s_keys, s_rows, t_keys, t_rows, t_machines,
                                  int(cap), small_side=small_side,
                                  device=dev, substrate=substrate)
        return (out, rep), int(out.dropped.max())

    if not defaulted_capacity:
        return attempt(out_capacity)[0]
    (out, rep), factor, attempts = run_with_capacity(
        attempt, CapacityPolicy.fixed(out_capacity, max_retries=3))
    rep.cap_factor = factor
    rep.capacity_attempts = attempts
    return out, rep


def moe_dispatch(params, x, cfg, *, mode: Optional[str] = None,
                 t_machines: int = 8, substrate=None, policy=None,
                 act: str = "swiglu", rng: Optional[torch.Generator] = None,
                 draws=None, device=None):
    """One MoE layer with its dispatch as a cluster workload.

    Token->expert routing is the skew-join problem (tokens keyed by
    expert id; a hot expert is Join Product Skew), so it dispatches like
    :func:`join`.  params: ``router`` (d, E) float32 and ``w_gate`` /
    ``w_up`` (E, d, ff), ``w_down`` (E, ff, d) (``models.moe.init_moe``),
    tensors or host arrays; x: (..., d) tokens.  Both are moved to the
    run's device.  Returns ``(y, report)``: y shaped like x on the
    device, and an AlphaKReport whose ``slot_workload`` /
    ``expert_workload`` are the measured dispatch balance.

    mode (default ``cfg.dispatch``):

    * ``"capacity"`` -- the dense capacity-factor layer
      (``models.moe.moe_layer``); hot experts drop assignments
      (``report.total_dropped``), the Standard Repartition Join's
      failure;
    * ``"alpha_k"`` -- the dense StatJoin-planned layer: hot-expert
      replicas and Theorem 6's slot capacity
      (``CapacityPolicy.moe_dispatch()``);
    * ``"cluster"`` -- the tokens routed through the instrumented
      exchange over ``t_machines`` (``core.moe_dispatch``): counts taped
      by the collectives, ``plan_slots`` driven by the planner's sketch
      of the routing ids, capacities from ``policy`` with retry on
      overflow; the token count must divide over ``t_machines``;
    * ``"auto"`` -- sketch the routing ids once
      (``planner.plan_moe_query``), score the three modes, run the
      winner; the report carries the plan as ``sort`` / ``join``'s do.

    The dense modes' report counts the slots as its "machines" (one
    program: no taped exchange, alpha 0).  ``rng`` (a generator on the
    device) or ``draws`` (injected draws) serve
    ``replica_choice="random"`` in the dense ``alpha_k`` layer.
    ``substrate``: see the module docstring.
    """
    from ..models.moe import moe_layer, route

    mode = cfg.dispatch if mode is None else mode
    if mode not in MOE_DISPATCH_MODES + (AUTO,):
        raise ValueError(f"unknown dispatch mode {mode!r}; expected one "
                         f"of {MOE_DISPATCH_MODES + (AUTO,)}")
    dev = resolve_device(device)
    xt = _as_tensor(_x32(x)).to(dev)
    p = {name: _as_tensor(_x32(w)).to(dev) for name, w in params.items()}
    d = int(xt.shape[-1])
    tt = xt.numel() // d
    e, k = int(cfg.num_experts), int(cfg.top_k)

    plan = sketch_phases = None
    if mode in (AUTO, "cluster"):
        if tt % t_machines:
            raise ValueError(
                f"moe_dispatch mode {mode!r} shards tokens over machines: "
                f"token count {tt} must divide over t_machines={t_machines}")
        from ..planner import plan_moe_query
        plan, sketch_phases = plan_moe_query(
            xt.reshape(tt, d), p["router"], t_machines=t_machines,
            num_experts=e, top_k=k, extra_slots=cfg.extra_slots,
            capacity_factor=cfg.capacity_factor, device=dev,
            substrate=substrate)
        if mode == AUTO:
            mode = plan.algorithm

    if mode == "cluster":
        from ..core.moe_dispatch import cluster_moe_dispatch
        from ..planner import expert_counts_estimate
        y, report = cluster_moe_dispatch(
            p, xt, cfg, t_machines=t_machines,
            counts=expert_counts_estimate(plan.profile, e),
            substrate=substrate, policy=policy, act=act)
        _attach_plan(report, plan, sketch_phases)
        return y, report

    from ..core.alpha_k import AlphaKReport
    cfg_run = (cfg if cfg.dispatch == mode
               else dataclasses.replace(cfg, dispatch=mode))
    y, stats = moe_layer(p, xt, cfg_run, act=act, rng=rng, draws=draws)
    slot_load = stats.slot_load.cpu().numpy().astype(np.int64)
    n_slots = int(slot_load.shape[0])
    # the routing histogram recounted on the host from the ids the
    # layer computed (the same expression)
    ids = route(xt.reshape(tt, d), p["router"], k)[1]
    expert_workload = np.bincount(ids.cpu().numpy().reshape(-1),
                                  minlength=e)
    report = AlphaKReport(algorithm=f"moe[{mode}]", t=n_slots,
                          n_in=tt * k, n_out=tt * k, workload=slot_load,
                          phases=[])
    report.dispatch_mode = mode
    report.slot_workload = slot_load
    report.expert_workload = expert_workload
    report.k_slot = float(slot_load.max() / max(1.0, tt * k / n_slots))
    report.k_expert = float(expert_workload.max() / max(1.0, tt * k / e))
    report.total_dropped = int(stats.dropped)
    if plan is not None:
        _attach_plan(report, plan, sketch_phases)
    return y, report
