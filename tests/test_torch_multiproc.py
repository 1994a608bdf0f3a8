"""The process-group substrate against the batch and the reference.

``ProcessGroupSubstrate`` spreads the t machines over the ranks of a
``torch.distributed`` group (Gloo on the CPU here), t / world rows a
rank; every collective between machines goes through the group.  Its
results must be bitwise what ``BatchedSubstrate`` gives on the same
whole operands -- keys, values, join pairs and every AlphaKReport field
-- and so the reference's (``repro.cluster.sort`` / ``join`` on its
``VmapSubstrate``, computed in this process; Terasort and RandJoin on
the reference's draws, rebuilt).

* World 1 runs in this process: a module fixture initialises the
  default group (file init) and destroys it at teardown.
* Worlds 2, 4 and 8 run in spawned ranks (``RANK_SCRIPT``, one
  subprocess a rank, file init in the test's temporary directory, no
  TCP port), each world once, at t = 8 and 16 (t_loc 1, 2, 4 and 8),
  every rank checking its whole results against the batch's, which
  this process computed and held against the reference.  A launcher
  kills its ranks at a deadline, so a hung rank fails the test.
* The tape alone: each collective and its grid forms against
  ``CollectiveTape`` on the same whole operand, the ragged exchange
  against a host loop, in the same spawns.

The backend ``"ragged"`` has no reference run on the CPU (the
reference's ragged exchange lowers for a TPU only): it is held against
the static backend's keys, values and report.
"""
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch.distributed as dist

from repro import cluster as jcluster
from repro_torch import cluster, planner
from repro_torch.cluster import (BatchedSubstrate, CollectiveTape,
                                 ProcessGroupSubstrate, ProcessGroupTape,
                                 SubstratePool, reset_default_pool)
from repro_torch.data import uniform_keys, zipf_tables
from repro_torch.serve import QueryEngine, join_query, sort_query
from repro_torch.serve.query import run_spec

from test_torch_randjoin import (assert_join_reports_equal,
                                 assert_outputs_equal, reference_assignments)
from test_torch_terasort import assert_reports_equal, reference_uniforms

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
RANK_DEADLINE_S = 150      # one spawn: start, every check, exit
GROUP_TIMEOUT_S = 60       # any one collective's wait

# What this process and every spawned rank both run: the cases, the
# report's comparable fields and the bitwise comparison.
SHARED = r'''
import numpy as np
import torch


def summary(rep):
    """Every comparable field of an AlphaKReport, host values: the
    MoE dispatch's and the planner's too (the plan's algorithm,
    topology, every candidate's costs, the sketch round's phases)."""
    import dataclasses
    from repro_torch.core import report_fields
    out = report_fields(rep)
    for key in ("boundaries", "exchange_topology",
                "theoretical_workload_bound", "total_dropped",
                "dispatch_mode", "slot_workload", "expert_workload",
                "k_slot", "k_expert", "capacity", "slot2expert",
                "slot_replicas", "predicted_alpha", "predicted_k",
                "predicted_k_network"):
        if hasattr(rep, key):
            out[key] = getattr(rep, key)
    plan = getattr(rep, "query_plan", None)
    if plan is not None:
        out["plan"] = (plan.algorithm, plan.exchange, {
            name: dataclasses.asdict(c)
            for name, c in sorted(plan.candidates.items())})
        out["sketch_phases"] = [
            (p.name, np.asarray(p.sent), np.asarray(p.received))
            for p in rep.sketch_phases]
    return out


def outputs(value):
    """A sort's (keys, values), a join's JoinOutput or an MoE layer's y
    as a dict."""
    if isinstance(value, torch.Tensor):
        return {"y": value}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return dict(value._asdict())
    return {"keys": value[0], "values": value[1]}


def differ(got, want, where=""):
    """The first place ``got`` and ``want`` differ in a bit, or None."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return f"{where}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            d = differ(got[k], want[k], f"{where}.{k}")
            if d:
                return d
        return None
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return f"{where}: {len(got)} items != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            d = differ(g, w, f"{where}[{i}]")
            if d:
                return d
        return None
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.dtype != want.dtype \
                or got.shape != want.shape:
            return f"{where}: {got!r:.80} is not a tensor like {want.dtype}"
        return (None if torch.equal(got.contiguous().view(torch.uint8),
                                    want.contiguous().view(torch.uint8))
                else f"{where}: tensors differ")
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        if got.dtype != want.dtype or got.shape != want.shape:
            return f"{where}: array {got.dtype}{got.shape} != " \
                   f"{want.dtype}{want.shape}"
        return (None if got.tobytes() == want.tobytes()
                else f"{where}: arrays differ")
    return None if got == want else f"{where}: {got!r} != {want!r}"


def port_run(case, substrate_type, fresh=True):
    """One front-door call of ``case`` on a ``substrate_type`` of its
    axes, with an empty plan cache unless ``fresh`` is False; returns
    (value, report)."""
    from repro_torch import cluster, planner
    if fresh:
        planner.clear_plan_cache()
    sub = substrate_type(*case["axes"])
    if case["kind"] == "sort":
        return cluster.sort(case["x"], values=case["v"], device="cpu",
                            substrate=sub, **case["kw"])
    if case["kind"] == "moe":
        return cluster.moe_dispatch(case["params"], case["x"], case["cfg"],
                                    device="cpu", substrate=sub,
                                    **case["kw"])
    return cluster.join(*case["tables"], device="cpu", substrate=sub,
                        **case["kw"])


def cleared_cache_check(cases, expected, rank):
    """Every auto case again with the plan cache of rank 0 alone
    cleared: the group agrees on a miss, every rank sketches, and the
    results are still the batch's.  Returns the first difference."""
    from repro_torch import planner
    from repro_torch.cluster import ProcessGroupSubstrate
    for name, case in cases.items():
        if not case.get("auto"):
            continue
        run_case(case, ProcessGroupSubstrate)       # every rank caches
        if rank == 0:
            planner.clear_plan_cache()
        before = planner.planner_stats().get("sketch_runs", 0)
        bad = differ(run_case(case, ProcessGroupSubstrate, fresh=False),
                     expected[name], name + " (cache cleared on rank 0)")
        if bad:
            return bad
        if planner.planner_stats().get("sketch_runs", 0) != before + 1:
            return f"{name}: rank {rank} did not sketch with rank 0"
    return None


def run_case(case, substrate_type, fresh=True):
    """:func:`port_run` as (outputs, summary), host-comparable."""
    value, rep = port_run(case, substrate_type, fresh)
    return outputs(value), summary(rep)
'''
exec(SHARED)  # noqa: S102 -- one source for this process and the ranks

RANK_SCRIPT = SHARED + r'''
import datetime
import pickle
import sys

import torch.distributed as dist

torch.set_num_threads(1)
world, rank, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from repro_torch.cluster import (CollectiveTape, ProcessGroupSubstrate,
                                 ProcessGroupTape)

try:
    ProcessGroupSubstrate(8)
    raise SystemExit("ProcessGroupSubstrate built with no group")
except RuntimeError:
    pass
dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=int(sys.argv[4])))
with open(f"{root}/cases.pkl", "rb") as f:
    cases, expected = pickle.load(f)
for t in (8, 16):
    if t % world == 0:
        tape_checks(t)
for name, case in cases.items():
    bad = differ(run_case(case, ProcessGroupSubstrate),
                 expected[case.get("want", name)], name)
    if bad:
        raise SystemExit(f"rank {rank}/{world}: {bad}")
bad = cleared_cache_check(cases, expected, rank)
if bad:
    raise SystemExit(f"rank {rank}/{world}: {bad}")
import warnings
from repro_torch.launch import make_staged_mesh, staged_axes
with warnings.catch_warnings():
    warnings.simplefilter("ignore")     # a world that does not factor
    mesh = make_staged_mesh(world)
axes = staged_axes(world) or (("i1", world),)
if (tuple(mesh.shape), tuple(mesh.mesh_dim_names)) != (
        tuple(s for _, s in axes), tuple(n for n, _ in axes)):
    raise SystemExit(f"staged mesh {mesh} on {world} ranks")
for t in (world + 1, 3 * world // 2):     # not a multiple of the world
    try:
        ProcessGroupSubstrate(t)
        raise SystemExit(f"ProcessGroupSubstrate({t}) on {world} ranks")
    except ValueError:
        pass
dist.barrier()
dist.destroy_process_group()
print(f"RANK {rank}/{world} OK", flush=True)
'''

# The tape's collectives on one rank against the batch tape on the
# whole operand: its rows of the result, and the same report.
TAPE_CHECKS = r'''
def tape_checks(t):
    import math
    g = torch.Generator().manual_seed(t)
    whole = torch.randn(t, t, 3, generator=g)
    whole[torch.rand(t, t, 3, generator=g) < 0.3] = float("inf")
    counts = torch.randint(0, 9, (t,), generator=g)
    grids = [(2, t // 2), (t // 2, 2), (4, t // 4)]
    local = ProcessGroupTape(None, t)
    batch = CollectiveTape()
    lo, rows = local.lo, local.rows
    mine = lambda y: y[lo:lo + rows]

    def same(a, b, what):
        if not torch.equal(a, b):
            raise SystemExit(f"t={t} rank {local.rank}: {what} differs")

    same(local.axis_index(rows), torch.arange(lo, lo + rows), "axis_index")
    with local.phase("gather"), batch.phase("gather"):
        same(local.all_gather(mine(whole[:, 0])),
             batch.all_gather(whole[:, 0]), "all_gather")
        same(local.all_gather(mine(whole), count=mine(counts)),
             batch.all_gather(whole, count=counts), "all_gather count")
        for grid in grids:
            for axis in (0, 1):
                same(local.all_gather(mine(whole), count=mine(counts),
                                      grid=grid, axis=axis),
                     mine(batch.all_gather(whole, count=counts, grid=grid,
                                           axis=axis)),
                     f"all_gather {grid} axis {axis}")
        same(local.all_gather_multi(mine(whole), grid=grids[2]),
             batch.all_gather_multi(whole, grid=grids[2]), "all_gather_multi")
    with local.phase("a2a"), batch.phase("a2a"):
        same(local.all_to_all(mine(whole), pad=math.inf,
                              sent=mine(counts)),
             mine(batch.all_to_all(whole, pad=math.inf, sent=counts)),
             "all_to_all")
        for grid in grids:
            for axis in (0, 1):
                tiles = whole[:, :grid[axis]]
                same(local.all_to_all(mine(tiles), pad=math.inf, grid=grid,
                                      axis=axis),
                     mine(batch.all_to_all(tiles, pad=math.inf, grid=grid,
                                           axis=axis)),
                     f"all_to_all {grid} axis {axis}")
        same(local.psum(mine(counts)), batch.psum(counts), "psum")
        same(local.psum(mine(counts), grid=grids[0], axis=1),
             mine(batch.psum(counts, grid=grids[0], axis=1)), "psum grid")
    t1, t2 = grids[2]
    relay = whole[:, :t1, None, :].expand(t, t1, t2, 3).contiguous()
    got, _ = local.staged_all_to_all(mine(relay), grid=grids[2],
                                     pad=math.inf, chunks=3)
    want, _ = batch.staged_all_to_all(relay, grid=grids[2], pad=math.inf,
                                      chunks=3)
    for (gk, _), (wk, _) in zip(got, want):
        same(gk, mine(wk), "staged_all_to_all")
    # ragged: machine s's segment to d is sizes[s, d] values from
    # offsets[s, d], landing after the segments of machines before s
    sizes = torch.randint(0, 4, (t, t), generator=g)
    starts = torch.cumsum(sizes, 1) - sizes
    operand = torch.randn(t, int(sizes.sum(1).max()) + 1, generator=g)
    land = torch.cumsum(sizes, 0) - sizes
    cap = int(sizes.sum(0).max()) + 2
    want = torch.full((t, cap), -1.0)
    for s in range(t):
        for d in range(t):
            n, a, b = int(sizes[s, d]), int(starts[s, d]), int(land[s, d])
            want[d, b:b + n] = operand[s, a:a + n]
    with local.phase("ragged"):
        got = local.ragged_all_to_all(
            mine(operand), torch.full((rows, cap), -1.0), mine(starts),
            mine(sizes), mine(land), mine(sizes.T))
    with batch.phase("ragged"):             # what the reference records
        batch.record(sent=sizes.sum(1), received=sizes.sum(0))
    same(got, mine(want), "ragged_all_to_all")
    for p, q in zip(local.phases(t), batch.phases(t)):
        if p.name != q.name or not (np.array_equal(p.sent, q.sent)
                                    and np.array_equal(p.received,
                                                       q.received)):
            raise SystemExit(f"t={t}: phase {p.name} differs from the batch")
'''
RANK_SCRIPT = TAPE_CHECKS + RANK_SCRIPT

T_CASES = (8, 16)
TABLES = zipf_tables(160, 160, theta=0.2, seed=1)
ROWS = np.arange(160, dtype=np.int32)


def cases():
    """name -> a front-door call and the substrate axes it runs on."""
    out = {}
    for t in T_CASES:
        m = 4096 // t
        x = uniform_keys(t * m, seed=t).reshape(t, m)
        v = np.arange(t * m, dtype=np.int32).reshape(t, m)
        sort = dict(kind="sort", x=x, v=None, axes=[t], kw={})
        out[f"smms t{t}"] = sort
        out[f"smms values t{t}"] = dict(sort, v=v)
        out[f"smms ragged t{t}"] = dict(sort, kw={"backend": "ragged"},
                                        want=f"smms t{t}")
        out[f"smms ragged values t{t}"] = dict(
            sort, v=v, kw={"backend": "ragged"}, want=f"smms values t{t}")
        out[f"smms staged t{t}"] = dict(sort, axes=[("i1", 4),
                                                    ("i2", t // 4)],
                                        kw={"exchange": "staged"})
        out[f"terasort t{t}"] = dict(
            sort, v=v, kw={"algorithm": "terasort",
                           "uniforms": reference_uniforms(0, t, m)})
        a, b = 2, t // 2
        ms = -(-len(TABLES[0]) // t)
        for algorithm in ("statjoin", "randjoin", "repartition",
                          "broadcast"):
            kw = {"algorithm": algorithm, "t_machines": t}
            axes = [t]
            if algorithm == "randjoin":
                kw.update(ab=(a, b), assignments=reference_assignments(
                    0, t, a, b, ms, ms))
                axes = [("a", a), ("b", b)]
            out[f"{algorithm} t{t}"] = dict(
                kind="join", tables=(TABLES[0], ROWS, TABLES[1], ROWS),
                axes=axes, kw=kw)
        # the planner: its sketch round on the substrate, then the
        # winner (Terasort and RandJoin draw from the seed: no reference)
        out[f"auto sort t{t}"] = dict(sort, v=v, kw={"algorithm": "auto"},
                                      auto=True, no_reference=True)
        out[f"auto join t{t}"] = dict(
            kind="join", tables=(TABLES[0], ROWS, TABLES[1], ROWS),
            axes=[t], kw={"algorithm": "auto", "t_machines": t}, auto=True,
            no_reference=True)
        for mode in ("cluster", "auto"):
            out[f"moe {mode} t{t}"] = dict(
                kind="moe", axes=[t], params=MOE_PARAMS, x=MOE_X,
                cfg=MOE_CFG, kw={"mode": mode, "t_machines": t}, auto=True,
                no_reference=True)
    return out


def _moe_setup(d=32, tokens=256, seed=0):
    """A small MoE layer (8 experts, top 2, expert 0 hot) and its tokens
    as host arrays; held against the reference in test_torch_moe_cluster."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import init_moe
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=16, extra_slots=4)
    p = init_moe(torch.Generator().manual_seed(seed), d, cfg, torch.float32,
                 "cpu")
    p["router"][:, 0] += 0.5
    x = np.random.default_rng(seed).standard_normal((tokens, d)).astype(
        np.float32)
    return {k: v.numpy() for k, v in p.items()}, x, cfg


MOE_PARAMS, MOE_X, MOE_CFG = _moe_setup()


def reference_run(case):
    """The reference's run of a case (its own draws for Terasort and
    RandJoin, which the case's injected draws rebuild)."""
    kw = {k: v for k, v in case["kw"].items()
          if k not in ("uniforms", "assignments")}
    if case["kind"] == "sort":
        return jcluster.sort(jnp.asarray(case["x"]), values=case["v"],
                             seed=0, **kw)
    return jcluster.join(*case["tables"], seed=0, **kw)


CASES = cases()
BATCH_CASES = [name for name, case in CASES.items() if "want" not in case]
REFERENCE_CASES = [name for name in BATCH_CASES
                   if not CASES[name].get("no_reference")]


@pytest.fixture(autouse=True)
def _reset_port_state():
    def reset():
        planner.clear_plan_cache()
        reset_default_pool()
    reset()
    yield
    reset()


def test_process_group_substrate_needs_a_group():
    """Before any group: the substrate refuses to build (the module's
    in-process group is made later, by the tests that ask for it)."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProcessGroupSubstrate(8)


@pytest.fixture(scope="module")
def batch():
    """Every case on the port's BatchedSubstrate: (value, report).  The
    ragged cases have none (the batch refuses them): they are held
    against their static twins."""
    return {name: port_run(CASES[name], BatchedSubstrate)
            for name in BATCH_CASES}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The default group of this process alone: Gloo, file init."""
    path = tmp_path_factory.mktemp("pg") / "pg"
    dist.init_process_group(
        "gloo", init_method=f"file://{path}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_batch_is_the_reference(batch, name):
    """The batch's results -- what every rank must give -- are the
    reference's: keys, values, join outputs, every report field."""
    case = CASES[name]
    value, rep = batch[name]
    want, want_rep = reference_run(case)
    if case["kind"] == "sort":
        np.testing.assert_array_equal(value[0].numpy().view(np.int32),
                                      np.asarray(want[0]).view(np.int32))
        if case["v"] is not None:
            np.testing.assert_array_equal(value[1].numpy(),
                                          np.asarray(want[1]))
        assert_reports_equal(rep, want_rep)
    else:
        assert_outputs_equal(value, want)
        assert_join_reports_equal(rep, want_rep)


@pytest.mark.parametrize("name", list(CASES))
def test_one_rank_is_the_batch(world1, batch, name):
    """World 1: each front door on a ProcessGroupSubstrate is the batch's
    call (ragged: the static call's), bitwise in every field."""
    case = CASES[name]
    value, rep = batch[case.get("want", name)]
    got = run_case(case, ProcessGroupSubstrate)
    assert differ(got, (outputs(value), summary(rep)), name) is None


exec(TAPE_CHECKS)  # noqa: S102 -- tape_checks, as the ranks run it


@pytest.mark.parametrize("t", T_CASES)
def test_one_rank_tape_is_the_batch_tape(world1, t):
    """Each collective and its grid forms on a one-rank group tape
    against CollectiveTape on the same operand; the ragged exchange
    against a host loop; the phases alike."""
    tape_checks(t)


def test_query_engine_serves_over_a_process_group(world1):
    """A pool of ProcessGroupSubstrate behind QueryEngine (two workers,
    whose runs the substrate serializes; a staged sort takes the pool's
    staged axes): every result the one-shot call's on the batch."""
    x, v = CASES["smms values t8"]["x"], CASES["smms values t8"]["v"]
    tables = CASES["statjoin t8"]["tables"]
    specs = [sort_query(x, values=v, algorithm="smms"),
             sort_query(x, algorithm="smms", exchange="staged"),
             sort_query(x, values=v, algorithm="terasort", seed=3),
             join_query(*tables, t_machines=8, algorithm="statjoin"),
             join_query(*tables, t_machines=8, algorithm="randjoin",
                        ab=(2, 4), seed=1),
             join_query(*tables, t_machines=8, algorithm="broadcast")]
    pool = SubstratePool(make=lambda *axes: ProcessGroupSubstrate(*axes))
    with QueryEngine(device="cpu", pool=pool, workers=2) as eng:
        results = eng.run(specs, timeout=120)
    for spec, res in zip(specs, results):
        assert res.ok, (spec, res.error)
        value, rep = run_spec(spec, device="cpu")       # the batch's
        assert differ((outputs(res.value), summary(res.report)),
                      (outputs(value), summary(rep)), str(spec.params)) is None
    assert {type(s) for s in pool.substrates()} == {ProcessGroupSubstrate}
    assert {s.axes for s in pool.substrates()} == {
        (("i", 8),), (("i1", 4), ("i2", 2)), (("a", 2), ("b", 4))}
    assert pool.stats()["runs"] == len(specs)


def test_default_substrate_and_mesh_on_one_rank(world1):
    """``default_substrate(prefer_mesh=True)`` takes the group where its
    size divides t (the batch otherwise); the staged mesh of a t that
    does not factor warns and is flat."""
    from repro_torch.cluster import compat, default_substrate
    from repro_torch.launch import make_staged_mesh, staged_axes
    assert type(default_substrate(8)) is BatchedSubstrate
    sub = default_substrate(("i1", 4), ("i2", 2), prefer_mesh=True)
    assert type(sub) is ProcessGroupSubstrate and sub.t_loc == 8
    assert compat.axis_size() == 1
    assert staged_axes(16) == (("i1", 4), ("i2", 4))
    assert staged_axes(6) is None
    mesh = compat.make_mesh((1,), ("i",))
    assert tuple(mesh.shape) == (1,) and mesh.mesh_dim_names == ("i",)
    with pytest.warns(UserWarning, match="factorization"):
        flat = make_staged_mesh(1)
    assert tuple(flat.shape) == (1,)
    with pytest.raises(ValueError, match="ranks"):
        compat.make_mesh((2, 2), ("a", "b"))


def test_errors_name_what_is_missing(world1, batch):
    """Ragged on the batch and with the staged exchange and an unknown
    backend raise, naming what is missing; algorithm="auto" on a group
    -- a substrate or a pool of them -- runs (the planner's sketch round
    on the group) and is the batch's call."""
    case = CASES["smms t8"]
    x = case["x"]
    with pytest.raises(NotImplementedError, match="ProcessGroupSubstrate"):
        cluster.sort(x, backend="ragged", device="cpu",
                     substrate=BatchedSubstrate(8))
    with pytest.raises(NotImplementedError, match="static backend only"):
        cluster.sort(x, backend="ragged", exchange="staged", device="cpu",
                     substrate=ProcessGroupSubstrate(("i1", 4), ("i2", 2)))
    with pytest.raises(ValueError, match="unknown exchange backend"):
        cluster.sort(x, backend="bogus", device="cpu",
                     substrate=ProcessGroupSubstrate(8))
    auto = CASES["auto sort t8"]
    got = cluster.sort(auto["x"], values=auto["v"], algorithm="auto",
                       device="cpu", substrate=ProcessGroupSubstrate(8))
    value, rep = batch["auto sort t8"]
    assert differ((outputs(got[0]), summary(got[1])),
                  (outputs(value), summary(rep)), "auto sort") is None
    got = cluster.join(*CASES["auto join t8"]["tables"], algorithm="auto",
                       t_machines=8, device="cpu",
                       substrate=SubstratePool(make=ProcessGroupSubstrate))
    value, rep = batch["auto join t8"]
    assert differ((outputs(got[0]), summary(got[1])),
                  (outputs(value), summary(rep)), "auto join") is None


def test_one_rank_agrees_on_a_cleared_plan_cache(world1, batch):
    """World 1: every auto case twice, the cache cleared before the
    second run; it sketches again and gives the batch's results."""
    expected = {name: (outputs(v), summary(r)) for name, (v, r)
                in batch.items()}
    assert cleared_cache_check(CASES, expected, 0) is None
    assert planner.planner_stats()["cache_misses"] > 0


def _launch(world: int, root) -> list:
    """``world`` ranks of RANK_SCRIPT; each is killed at the deadline.
    Returns their (exit code, output)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # the ranks meet locally
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(world), str(rank), str(root),
         str(GROUP_TIMEOUT_S)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    deadline = time.monotonic() + RANK_DEADLINE_S
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("world", [2, 4, 8])
def test_spawned_ranks_are_the_batch(batch, world, tmp_path):
    """Worlds 2, 4 and 8 at t = 8 and 16: on every rank, every case's
    whole result is the batch's, the tape's collectives are the batch
    tape's, and a t the world does not divide is refused."""
    expected = {name: (outputs(v), summary(r)) for name, (v, r)
                in batch.items()}
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump((CASES, expected), f)
    try:
        results = _launch(world, tmp_path)
    except subprocess.TimeoutExpired:
        pytest.fail(f"world {world}: a rank passed the {RANK_DEADLINE_S} s "
                    f"deadline")
    for rank, (code, text) in enumerate(results):
        assert code == 0 and f"RANK {rank}/{world} OK" in text, text[-3000:]
