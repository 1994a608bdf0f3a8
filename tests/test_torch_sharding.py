"""The port's sharding rules and the model on a mesh.

* ``repro_torch.sharding.specs`` against ``repro.sharding.specs`` on
  device-free meshes (a ``jax.sharding.AbstractMesh`` for the
  reference, a stand-in with ``.shape`` and ``.axis_names`` for the
  port) for all ten configurations on (16, 16), (2, 16, 16) and (2, 2):
  the parameter specs (the reference's period-stacked spec without its
  leading entry), the cache specs of the prefill_32k / decode_32k /
  long_500k inputs, ``batch_spec``, ``kv_cache_spec``, ``moe_groups``
  and the ``hidden`` / ``heads`` / ``ffn`` / ``moe_slots`` /
  ``group_major`` layouts (the reference's constraint read off its
  rules), entry by entry.  ``mesh=None``: every method the identity.
* One spawned Gloo world of 4 ranks as a ('data', 'model') = (2, 2)
  mesh (``RANK_SCRIPT``), against ``mesh=None`` runs of the same
  weights made here: the smoke configs of gemma-2b, granite-moe-3b-a800m
  and mamba2-130m (and gemma-2b with 3 heads, which shard the query
  sequence, or at 31 positions neither; gemma3-12b's sliding window on
  one row, whose cache splits its sequence over every axis;
  sequence-parallel; FSDP; granite with 5 experts, which split their
  d_ff) -- a train step's loss (rtol 1e-5) and every
  gradient leaf (within 1e-4 of the leaf's largest magnitude), the step
  function's loss and gradient norm (rtol 1e-5); a prefill and two
  decode steps (logits rtol 1e-4 of their largest magnitude, greedy
  tokens equal); a checkpoint saved on (2, 2) and restored onto (1, 4)
  and onto no mesh (bitwise); ``launch.train(mesh=)``'s losses.  The
  float32 tolerances bound the reordered tensor-parallel sums; the
  measured errors are below 5e-6 (CHANGES.md).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.models import model as jmodel
from repro.sharding.specs import make_rules as jmake_rules
from repro_torch.configs import ARCHS, SHAPES, get_arch, smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.models.convert import tree_leaves
from repro_torch.sharding import P, make_rules, placements

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
RANK_DEADLINE_S = 240


class StandInMesh:
    """A mesh no process holds: its shape and axis names."""

    def __init__(self, shape, names):
        self.shape, self.axis_names = tuple(shape), tuple(names)


def _both(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    jrules = jmake_rules(AbstractMesh(shape, names), JARCHS[arch])
    rules = make_rules(StandInMesh(shape, names), ARCHS[arch])
    return jrules, rules


def _spec(s):
    return tuple(s)


def _reference_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]


def _period_paths(jtree):
    """{(pos, ..., name): reference spec} of the period-stacked leaves,
    {name: spec} of the others."""
    out = {}
    for path, spec in _reference_leaves(jtree):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        out[keys] = spec
    return out


def _port_paths(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_paths(v, prefix + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for keys, spec in _port_paths(v, prefix).items():
                out.setdefault(keys, []).append(spec)
    else:
        out[prefix] = tree
    return out


def _assert_stacked_equal(jspecs, specs):
    """Every leaf's port spec (one a period) is the reference's without
    the leading period entry; the rest equal."""
    want = _period_paths(jspecs)
    got = _port_paths(specs)
    assert set(got) == set(want)
    for keys, spec in got.items():
        ref = tuple(want[keys])
        if keys[0] == "periods":
            assert ref[0] is None
            for s in spec:
                assert isinstance(s, P) and _spec(s) == ref[1:], keys
        else:
            assert _spec(spec) == ref, keys


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_are_the_reference(arch, mesh_name):
    """Parameter and cache specs, batch and kv-cache specs, the MoE
    group count and the activation layouts, entry by entry."""
    jrules, rules = _both(arch, mesh_name)
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    assert (rules.batch_axes, rules.fsdp) == (jrules.batch_axes,
                                              jrules.fsdp)
    _assert_stacked_equal(jrules.param_specs(jmodel.params_shape(jcfg)),
                          rules.param_specs(model.params_shape(cfg)))
    for shape_name in ("prefill_32k", "decode_32k", "long_500k"):
        shp = SHAPES[shape_name]
        b, s = shp.global_batch, shp.seq_len
        jcache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, b, s))
        _assert_stacked_equal(
            jrules.cache_specs(jcache),
            rules.cache_specs(model.init_cache(cfg, b, s, device="meta")))
        assert _spec(rules.kv_cache_spec(b, s)) == _spec(
            jrules.kv_cache_spec(b, s))
        assert _spec(rules.batch_spec(b)) == _spec(jrules.batch_spec(b))
    assert rules.moe_groups() == jrules.moe_groups()
    # the reference's activation constraints, read off its rules
    jrules.constrain = lambda x, spec: spec
    sds = lambda *shape: jax.ShapeDtypeStruct(shape, np.float32)  # noqa
    hd = cfg.head_dim_
    for name, shp in list(SHAPES.items()) + [("smoke", ShapeSpec(
            "smoke", "train", 32, 4))]:
        b, s = shp.global_batch, shp.seq_len
        for seq in (s, 1):
            assert _spec(rules.hidden_spec((b, seq, cfg.d_model))) == \
                _spec(jrules.hidden(sds(b, seq, cfg.d_model)))
            for h in {cfg.n_heads, cfg.n_kv_heads} - {0}:
                assert _spec(rules.heads_spec((b, seq, h, hd))) == \
                    _spec(jrules.heads(sds(b, seq, h, hd)))
            assert _spec(rules.ffn_spec((b, seq, max(cfg.d_ff, 1)))) == \
                _spec(jrules.ffn(sds(b, seq, max(cfg.d_ff, 1))))
    for ndim in (3, 4):
        assert _spec(rules.moe_slots_spec(ndim)) == _spec(
            jrules.moe_slots(sds(*(2,) * ndim)))
        assert _spec(rules.group_major_spec(ndim)) == _spec(
            jrules.group_major(sds(*(2,) * ndim)))


def test_no_mesh_is_the_identity():
    """``mesh=None``: the reference's rules, every layout method the
    identity (the same tensor back)."""
    rules = make_rules(None, ARCHS["gemma-2b"])
    assert rules.mesh is None and rules.moe_groups() == 1
    x = torch.ones(2, 4, 3)
    for fn in (rules.hidden, rules.ffn, rules.moe_slots, rules.group_major):
        assert fn(x) is x
    assert rules.heads(x[..., None]).shape == (2, 4, 3, 1)


def test_placements_follow_the_mesh_order():
    """A dim split over several axes is split outer axis first, as
    JAX's major-to-minor spec; another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandInMesh((2, 16, 16), ("pod", "data", "model"))
    rules = make_rules(mesh, ARCHS["jamba-1.5-large-398b"])
    spec = rules.kv_cache_spec(1, 524_288)[1:]      # the port's (unstacked)
    assert placements(P(*spec), mesh) == (Shard(2), Shard(2), Shard(2))
    assert placements(P(None, "model"), mesh) == (Replicate(), Replicate(),
                                                  Shard(1))
    with pytest.raises(ValueError, match="order"):
        placements(P(("model", "data")), mesh)


# ---------------------------------------------------------------------------
# one spawned world of 4 Gloo ranks: the (2, 2) mesh
# ---------------------------------------------------------------------------

def _variants():
    """name -> (arch, config overrides, rules options, batch, seq)."""
    granite = smoke_config(get_arch("granite-moe-3b-a800m"))
    return {
        "gemma-2b": ("gemma-2b", {}, {}, 4, 32),
        "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}, {}, 4, 32),
        "mamba2-130m": ("mamba2-130m", {}, {}, 4, 32),
        "gemma-2b 3 heads": ("gemma-2b", {"n_heads": 3}, {}, 4, 32),
        "gemma-2b 3 heads, 31 positions": ("gemma-2b", {"n_heads": 3}, {},
                                           4, 31),
        "gemma3-12b one row": ("gemma3-12b", {}, {}, 1, 32),
        "gemma-2b seq-parallel": ("gemma-2b", {}, {"seq_parallel": True},
                                  4, 32),
        "granite fsdp 5 experts": (
            "granite-moe-3b-a800m",
            {"moe": dataclasses.replace(granite.moe, num_experts=5)},
            {"fsdp_threshold": 0}, 4, 32),
    }


VARIANTS = _variants()
# the serving checks: each attention layout (heads over 'model', the
# query sequence, neither), the cache's sequence over 'model' and over
# every axis (one row), the MoE and the SSM layers
SERVE = ["gemma-2b", "granite-moe-3b-a800m", "mamba2-130m",
         "gemma-2b 3 heads", "gemma-2b 3 heads, 31 positions",
         "gemma3-12b one row"]


def _config(name):
    arch, over = VARIANTS[name][:2]
    return dataclasses.replace(smoke_config(get_arch(arch)), **over)


def _inputs(name):
    cfg = _config(name)
    b, s = VARIANTS[name][3:]
    g = torch.Generator().manual_seed(1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g
                        ).to(torch.int32)
    return params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


SHARED = r'''
import dataclasses

import torch

from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.models.convert import tree_leaves


def grads(cfg, params, batch, rules):
    """(loss, gradient leaves) of train_loss: whole, or on a mesh each
    rank's share summed as the train step sums it, then gathered."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.train_loss(params, cfg, batch, rules=rules)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    if rules is None:
        return float(loss.detach()), [g.detach() for g in gs]
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import _mesh_grads
    from repro_torch.sharding.parallel import Par
    par = Par(rules)
    loss = float(par.batch_sum_(loss.detach().clone()))
    whole = [DTensor.from_local(g, rules.mesh, p.placements, run_check=False,
                                shape=p.shape, stride=p.stride()).full_tensor()
             for g, p in zip(_mesh_grads(gs, leaves, par), leaves)]
    return loss, whole


def serve(cfg, params, tokens, rules):
    """Prefill, then two greedy decode steps: the three logits."""
    cache = model.init_cache(cfg, tokens.shape[0], tokens.shape[1] + 4,
                             device="cpu")
    if rules is not None:
        cache = steps.shard_cache(rules, cache)
    out = []
    with torch.no_grad():
        logits, cache = model.prefill(params, cfg, tokens, cache,
                                      rules=rules)
        for i in range(3):
            if rules is not None:
                logits = logits.full_tensor()
            out.append(logits)
            if i < 2:
                tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
                logits, cache = model.decode_step(
                    params, cfg, tok.to(torch.int32), cache, rules=rules)
    return out


def step(cfg, params, batch, mesh, **kw):
    """One train step on a copy of ``params`` (the step updates its
    parameters in place, and a leaf no axis splits is shared with the
    tree given): the loss, the gradient norm, the new parameters and
    moments."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.convert import tree_map
    from repro_torch.optim.adamw import adamw_init
    bundle = steps.build_train_step(cfg, mesh, ShapeSpec(
        "s", "train", batch["tokens"].shape[1], batch["tokens"].shape[0]),
        **kw)
    params = steps.shard_params(bundle.rules,
                                tree_map(lambda t: t.detach().clone(), params))
    opt = adamw_init(params)
    params, opt, metrics = bundle.fn(params, opt,
                                     steps.shard_batch(bundle.rules, batch))
    return float(metrics["loss"]), float(metrics["grad_norm"]), params, opt
'''
exec(SHARED)  # noqa: S102 -- one source for this process and the ranks

RANK_SCRIPT = SHARED + r'''
import datetime
import json
import pickle
import sys

import torch.distributed as dist

torch.set_num_threads(1)
world, rank, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=90))
from repro_torch.ckpt import CheckpointManager
from repro_torch.cluster import compat
from repro_torch.launch.mesh import make_host_mesh
with open(f"{root}/cases.pkl", "rb") as f:
    cases = pickle.load(f)
mesh = make_host_mesh(4)
assert tuple(mesh.shape) == (2, 2) and mesh.mesh_dim_names == (
    "data", "model"), mesh
results = {}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


for name, case in cases.items():
    cfg, params, batch, kw = (case[k] for k in ("cfg", "params", "batch",
                                                "kw"))
    rules = steps.rules_for(cfg, mesh, **kw)
    sharded = steps.shard_params(rules, params)
    loss, gs = grads(cfg, sharded, batch, rules)
    want_loss, want_gs = case["grads"]
    results[f"train {name}"] = {
        "loss": abs(loss - want_loss) / abs(want_loss),
        "grad": max(rel(a, b) for a, b in zip(gs, want_gs))}
    loss, gnorm, _, _ = step(cfg, params, batch, mesh, **kw)
    results[f"step {name}"] = {
        "loss": abs(loss - case["step"][0]) / abs(case["step"][0]),
        "grad_norm": abs(gnorm - case["step"][1]) / abs(case["step"][1])}
    if "serve" in case:
        got = serve(cfg, sharded, batch["tokens"], rules)
        results[f"serve {name}"] = {
            "logits": max(rel(a, b) for a, b in zip(got, case["serve"])),
            "tokens_equal": all(bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                                for a, b in zip(got, case["serve"]))}

# a checkpoint of a step's parameters and moments saved on (2, 2),
# restored onto (1, 4) and onto no mesh
case = cases["granite-moe-3b-a800m"]
cfg = case["cfg"]
_, _, params, opt = step(cfg, case["params"], case["batch"], mesh)
manager = CheckpointManager(f"{root}/ckpt")
manager.save(1, {"params": params, "opt": opt})
whole = [t.full_tensor() for t in tree_leaves({"params": params,
                                               "opt": opt})
         if hasattr(t, "full_tensor")]
mesh14 = compat.make_mesh((1, 4), ("data", "model"))
rules14 = steps.rules_for(cfg, mesh14)
like = {"params": steps.shard_params(rules14, case["params"]),
        "opt": steps.shard_opt_state(rules14, case["opt0"])}
back = [t.full_tensor() for t in tree_leaves(manager.restore(1, like))
        if hasattr(t, "full_tensor")]
plain = [t for t in tree_leaves(manager.restore(
    1, {"params": case["params"], "opt": case["opt0"]}))
    if isinstance(t, torch.Tensor) and t.dim() > 0]
results["checkpoint (1, 4)"] = {"bitwise": len(back) == len(whole) and all(
    torch.equal(a, b) for a, b in zip(back, whole))}
results["checkpoint no mesh"] = {"bitwise": len(plain) == len(whole) and all(
    torch.equal(a, b) for a, b in zip(plain, whole))}

# the training loop: two steps on the mesh
from repro_torch.launch.train import train
cfg = cases["gemma-2b"]["cfg"]
losses = train(cfg, steps=2, mesh=mesh, batch=4, seq=16, device="cpu",
               log_every=100)
results["train loop"] = {"losses": losses}
if rank == 0:
    with open(f"{root}/results.json", "w") as f:
        json.dump(results, f)
dist.barrier()
dist.destroy_process_group()
print(f"RANK {rank}/{world} OK", flush=True)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results: every check's measured error, keyed."""
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import adamw_init
    root = tmp_path_factory.mktemp("mesh")
    cases = {}
    for name, (_, _, kw, _, _) in VARIANTS.items():
        cfg = _config(name)
        params, batch = _inputs(name)
        case = {"cfg": cfg, "params": params, "batch": batch, "kw": kw,
                "opt0": adamw_init(params)}
        case["grads"] = grads(cfg, params, batch, None)
        case["step"] = step(cfg, params, batch, None)[:2]
        params, _ = _inputs(name)       # without requires_grad
        case["params"] = params
        if name in SERVE:
            case["serve"] = serve(cfg, params, batch["tokens"], None)
        cases[name] = case
    with open(root / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, "4", str(rank), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(4)]
    deadline = time.monotonic() + RANK_DEADLINE_S
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (code, text) in enumerate(outs):
        assert code == 0 and f"RANK {rank}/4 OK" in text, text[-3000:]
    with open(root / "results.json") as f:
        results = json.load(f)
    results["train loop want"] = train(
        _config("gemma-2b"), steps=2, batch=4, seq=16, device="cpu",
        log_every=100)
    return results


@pytest.mark.parametrize("name", list(VARIANTS))
def test_mesh_train_step_is_no_mesh(world, name):
    """Loss rtol 1e-5, each gradient leaf within 1e-4 of its largest
    magnitude; the step function's loss and gradient norm rtol 1e-5."""
    got = world[f"train {name}"]
    assert got["loss"] <= 1e-5 and got["grad"] <= 1e-4, got
    got = world[f"step {name}"]
    assert got["loss"] <= 1e-5 and got["grad_norm"] <= 1e-5, got


@pytest.mark.parametrize("name", SERVE)
def test_mesh_prefill_and_decode_are_no_mesh(world, name):
    """The prefill's and two decode steps' logits within 1e-4 of their
    largest magnitude, and the same greedy tokens."""
    got = world[f"serve {name}"]
    assert got["logits"] <= 1e-4 and got["tokens_equal"], got


@pytest.mark.parametrize("onto", ["(1, 4)", "no mesh"])
def test_checkpoint_restores_onto_another_mesh(world, onto):
    """Saved on (2, 2), restored bitwise onto (1, 4) and onto no mesh."""
    assert world[f"checkpoint {onto}"]["bitwise"]


def test_train_loop_on_a_mesh(world):
    """``launch.train(mesh=make_host_mesh())``: the same losses as
    without a mesh, rtol 1e-5."""
    np.testing.assert_allclose(world["train loop"]["losses"],
                               world["train loop want"], rtol=1e-5)


def test_step_bundle_carries_the_rules():
    cfg = smoke_config(get_arch("gemma-2b"))
    bundle = steps.build_step(cfg, None, SHAPES["decode_32k"])
    assert bundle.rules.mesh is None and bundle.rules.batch_axes == ("data",)
    assert len(tree_leaves(bundle.arg_shapes[0])) > 0
