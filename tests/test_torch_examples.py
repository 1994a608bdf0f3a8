"""The port's examples (``examples/torch_*.py``) on the CPU.

Each example's ``main(["--device", "cpu", ...])`` runs at its own sizes
(``torch_train_lm`` for 4 steps) and what it returns is held against
the reference's front door on the same inputs: sorted keys and every
``AlphaKReport`` field bitwise, ``imbalance`` exactly, the join pairs,
the auto join's plan.  Terasort and RandJoin draw the reference's
``jax.random`` draws (the port's draw functions swapped for the
reference's, as the port's own tests inject them).  The reference's
examples themselves are not imported: ``sort_cluster.py`` sets
``XLA_FLAGS`` at import.  ``torch_sort_cluster`` runs as one Gloo rank
of a group this test makes, with file init in ``tmp_path``.
"""
import dataclasses
import datetime
import importlib
import importlib.util
import math
import os
import pathlib
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import cluster as jcluster
from repro import planner as jplanner
from repro.serve import LengthBucketScheduler as JScheduler
from repro_torch import cluster, obs, planner
from repro_torch.core import report_fields
from repro_torch.data import (lidar_like, scalar_skew_tables, uniform_keys,
                              zipf_tables)
from repro_torch.kernels import ops

from test_torch_randjoin import reference_assignments
from test_torch_terasort import reference_uniforms

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: the examples' eager ops
    are small, and the suite runs several worker processes at once,
    whose extra threads would only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_and_draw_as_the_reference(monkeypatch):
    """Fresh plan caches on both sides, and the reference's draws for
    the port's Terasort and RandJoin."""
    def uniforms(t, m, seed, device):
        return torch.from_numpy(reference_uniforms(seed, t, m)).to(device)

    def assignments(t, ms, mt, a, b, seed, device):
        return tuple(torch.from_numpy(v).to(device) for v in
                     reference_assignments(seed, t, a, b, ms, mt))

    # the modules (repro_torch.core exports a function named randjoin)
    monkeypatch.setattr(importlib.import_module("repro_torch.core.terasort"),
                        "draw_uniforms", uniforms)
    monkeypatch.setattr(importlib.import_module("repro_torch.core.randjoin"),
                        "draw_assignments", assignments)
    for reset in (planner.clear_plan_cache, jplanner.clear_plan_cache,
                  cluster.reset_default_pool, obs.reset_registry):
        reset()
    yield
    planner.clear_plan_cache()
    cluster.reset_default_pool()


def same_report(got, want) -> None:
    g, w = report_fields(got), report_fields(want)
    assert [p[0] for p in g["phases"]] == [p[0] for p in w["phases"]]
    for (_, gs, gr), (_, ws, wr) in zip(g["phases"], w["phases"]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(g.pop("workload"), w.pop("workload"))
    g.pop("phases"), w.pop("phases")
    assert g == w
    assert got.imbalance == want.imbalance


def same_keys(got: np.ndarray, want) -> None:
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def pairs(out) -> set:
    s = np.asarray(out.s_rows).reshape(-1)
    t = np.asarray(out.t_rows).reshape(-1)
    v = np.asarray(out.valid).reshape(-1)
    return set(zip(s[v].tolist(), t[v].tolist()))


def same_fields(got, want, name="") -> None:
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            same_fields(getattr(got, f.name), getattr(want, f.name),
                        f"{name}.{f.name}")
    elif isinstance(want, (np.ndarray, jnp.ndarray)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=name)
    elif isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            same_fields(got[k], want[k], f"{name}[{k}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), name
    else:
        assert got == want, name


def same_plan(got, want) -> None:
    assert (got.kind, got.algorithm, got.t, got.cached, got.exchange) == (
        want.kind, want.algorithm, want.t, want.cached, want.exchange)
    same_fields(got.candidates, want.candidates, "candidates")
    same_fields(got.profile, want.profile, "profile")


def check_join(got, want_run) -> None:
    out, rep = got
    jout, jrep = want_run
    same_report(rep, jrep)
    assert pairs(out) == pairs(jout)


def test_quickstart():
    got = load("torch_quickstart").main(CPU)
    t, m = 8, 4096
    x = jnp.asarray(lidar_like(t * m, seed=0).reshape(t, m))
    (keys, _), rep = jcluster.sort(x, algorithm="smms", r=2)
    same_keys(got["smms"][0], keys)
    same_report(got["smms"][1], rep)
    (keys, _), rep = jcluster.sort(x, algorithm="terasort", seed=0)
    same_keys(got["terasort"][0], keys)
    same_report(got["terasort"][1], rep)
    n = 4000
    s, tk = scalar_skew_tables(n, m_hot=400, n_hot=100, seed=1)
    rows = np.arange(n)
    for alg in jcluster.JOIN_ALGORITHMS:
        check_join(got["joins"][alg], jcluster.join(
            s, rows, tk, rows, algorithm=alg, t_machines=8))
    want = jcluster.join(s, rows, tk, rows, algorithm="auto", t_machines=8)
    check_join(got["auto"], want)
    same_plan(got["auto"][1].query_plan, want[1].query_plan)
    assert got["auto"][1].predicted_k == want[1].predicted_k


def test_sort_cluster_as_one_gloo_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        got = load("torch_sort_cluster").main(CPU)
    finally:
        dist.destroy_process_group()
    t, m = 8, 1 << 14
    x = jnp.asarray(lidar_like(t * m, seed=3).reshape(t, m))
    (keys, _), rep = jcluster.sort(x, algorithm="smms", r=2)
    same_keys(got["keys"], keys)
    same_report(got["report"], rep)
    xk = jnp.asarray(lidar_like(t * 1024, seed=3).reshape(t, 1024))
    (keys_k, _), rep_k = jcluster.sort(xk, algorithm="smms", r=2)
    same_keys(got["keys_kernel"], keys_k)
    same_keys(got["keys_plain"], keys_k)
    same_report(got["report_kernel"], rep_k)


def test_sort_cluster_makes_and_removes_its_own_group():
    assert not dist.is_initialized()
    got = load("torch_sort_cluster").main(CPU)
    assert not dist.is_initialized()
    assert got["report"].capacity_attempts == 1


def test_skew_join():
    got = load("torch_skew_join").main(CPU)
    n, t = 3000, 8
    rows = np.arange(n)
    for theta in (0.0, 1.0):
        s, tk = zipf_tables(n, n, theta=theta, seed=2, domain=150)
        run = got[theta]
        assert run["W"] == len(pairs(run["runs"]["statjoin"][0]))
        for alg, result in run["runs"].items():
            check_join(result, jcluster.join(s, rows, tk, rows,
                                             algorithm=alg, t_machines=t))
        want = jcluster.join(s, rows, tk, rows, algorithm="auto",
                             t_machines=t)
        same_report(run["auto"], want[1])
        same_plan(run["auto"].query_plan, want[1].query_plan)
        assert (run["auto"].predicted_alpha, run["auto"].predicted_k) == (
            want[1].predicted_alpha, want[1].predicted_k)
        assert run["auto_again"].query_plan.cached
        assert run["auto_again"].sketch_phases == []


def test_serve_requests():
    got = load("torch_serve_requests").main(CPU)
    q = got["queries"]
    assert all(r.ok for r in q["results"]) and len(q["results"]) == 40
    t = 8
    xs = [jnp.asarray(uniform_keys(t * 512, seed=s).reshape(t, 512))
          for s in range(3)]
    sk, tk = zipf_tables(800, 800, theta=0.5, seed=7, domain=100)
    rows = np.arange(800)
    want = [jcluster.sort(xs[0], algorithm="smms"),
            jcluster.sort(xs[1], algorithm="auto"),
            jcluster.sort(xs[2], algorithm="terasort"),
            jcluster.join(sk, rows, tk, rows, algorithm="auto",
                          t_machines=t),
            jcluster.join(sk, rows, tk, rows, algorithm="statjoin",
                          t_machines=t)]
    for pick, res in zip(q["picks"], q["results"]):
        value, rep = want[pick]
        same_report(res.report, rep)
        if pick < 3:
            same_keys(res.value[0].numpy(), value[0])
        else:
            assert pairs(res.value) == pairs(value)
    llm = got["llm"]
    plan = JScheduler(max_batch=6, buckets=4).plan(llm["lengths"].tolist())
    assert [list(b) for b in llm["plan"]] == [list(b) for b in plan]
    assert llm["padding_waste"] == JScheduler.padding_waste(
        llm["lengths"], plan)
    vocab = llm["cfg"].vocab_size
    assert [len(b) for b in plan] == [tok.shape[0] for tok in llm["tokens"]]
    for tok in llm["tokens"]:
        assert tok.shape[1] == 4
        assert tok.min() >= 0 and tok.max() < vocab


def test_traced_query():
    got = load("torch_traced_query").main(CPU)
    try:
        res = got["result"]
        t, m = 8, 512
        x = jnp.asarray(uniform_keys(t * m, seed=5).reshape(t, m))
        (keys, _), rep = jcluster.sort(x, algorithm="auto")
        same_keys(res.value[0].numpy(), keys)
        same_report(res.report, rep)
        assert res.report.query_plan.cached
        assert os.path.getsize(got["trace_path"]) > 0
        assert got["stats"].served == 1
    finally:
        shutil.rmtree(os.path.dirname(got["trace_path"]), ignore_errors=True)


def test_train_lm():
    got = load("torch_train_lm").main(CPU + ["--steps", "4"])
    cfg = got["cfg"]
    assert (cfg.d_model, cfg.vocab_size, cfg.param_dtype) == (
        256, 8192, torch.float32)
    assert len(got["losses"]) == 4
    assert all(math.isfinite(v) for v in got["losses"])
    # a first loss near ln(vocab): random weights on a skewed stream
    assert abs(got["losses"][0] - math.log(cfg.vocab_size)) < 1.0
    toks = got["tokens"]
    assert toks.shape == (2, 8)
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_sort_cluster",
                                  "torch_skew_join", "torch_serve_requests",
                                  "torch_traced_query", "torch_train_lm"])
def test_example_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(name).main([])
    assert not dist.is_initialized()
    assert not obs.get_tracer().enabled
