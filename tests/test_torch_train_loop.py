"""The port's training loop and the modules around it.

* ``launch.train.train``: the loss falls; a checkpoint and a resume
  land on the uninterrupted run's losses (the reference's
  ``tests/test_train_e2e.py`` contract); a mesh raises naming ROADMAP
  A7.
* ``ckpt.CheckpointManager``: round trip, ``keep``, the leaf checks,
  bf16 leaves exactly, and the reference's manifest for the same tree.
* ``data.TokenPipeline``: a pure function of (seed, step);
  ``smms_length_bucketing`` bitwise the reference's.
* ``optim.grad_compress``: ``compress_decompress`` and
  ``compressed_psum`` bitwise the reference's (the latter under
  ``jax.vmap`` with a named axis, as its own test runs it).
* ``configs.input_specs`` and ``models.model.params_shape``: the
  reference's shapes and dtypes for every configuration and shape.
* ``launch.roofline``: the H100's constants, and every chip-independent
  quantity (stream bytes, exchange buffers, ``model_flops``,
  ``extrapolate``) equal to the reference's.
* ``launch.steps``: the prefill and decode steps are the direct calls.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import input_specs as jinput_specs
from repro.data.pipeline import smms_length_bucketing as jbucketing
from repro.launch import roofline as jroofline
from repro.models import model as jmodel
from repro.optim import grad_compress as jgc
from repro_torch.ckpt import CheckpointManager
from repro_torch.cluster.collectives import CollectiveTape
from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, get_arch,
                                 input_specs, smoke_config)
from repro_torch.data import TokenPipeline, smms_length_bucketing
from repro_torch.launch import roofline, steps
from repro_torch.launch.train import train
from repro_torch.models import model
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.optim import grad_compress as gc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: its eager ops are tiny,
    and the suite runs several worker processes at once, whose extra
    threads would only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(arch="gemma-2b"):
    return dataclasses.replace(smoke_config(get_arch(arch)), vocab_size=512,
                               d_model=64)


TRAIN_KW = dict(batch=4, seq=32, lr=3e-3, log_every=1000, device="cpu")


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-3b-a800m"])
def test_loss_decreases(arch):
    losses = train(tiny(arch), steps=30, **TRAIN_KW)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, (
        losses[:5], losses[-5:])


def test_checkpoint_restart_is_exact(tmp_path):
    """Kill-and-resume lands on the uninterrupted trajectory: the
    pipeline is stateless and the checkpoint carries params + opt."""
    cfg = tiny()
    kw = dict(TRAIN_KW, ckpt_every=10)
    full = train(cfg, steps=30, ckpt_dir=str(tmp_path / "a"), **kw)
    train(cfg, steps=20, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train(cfg, steps=30, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(resumed) == 10
    np.testing.assert_allclose(resumed, full[20:], rtol=1e-5, atol=1e-6)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [10, 20, 30]


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(tiny(), steps=1, batch=2, seq=8)


@pytest.mark.parametrize("build", ["train", "prefill", "decode", "loop"])
def test_a_mesh_raises_naming_a7(build):
    """A mesh that is not a DeviceMesh raises TypeError (the name is
    from when every mesh raised, naming ROADMAP A7)."""
    cfg, shape = tiny(), ShapeSpec("s", "train", 32, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        if build == "loop":
            train(cfg, steps=1, mesh=object(), batch=2, seq=8, device="cpu")
        else:
            getattr(steps, f"build_{build}_step")(cfg, object(), shape)


def test_prefill_and_decode_steps_are_the_direct_calls():
    cfg = smoke_config(get_arch("gemma3-12b"))
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    pre = steps.build_step(cfg, None, ShapeSpec("p", "prefill", 26, 2))
    dec = steps.build_step(cfg, None, ShapeSpec("d", "decode", 26, 2))
    assert pre.arg_shapes[1].shape == (2, 26)
    assert dec.arg_shapes[1].shape == (2, 1)
    outs = []
    for use_steps in (True, False):
        cache = model.init_cache(cfg, 2, 26, device="cpu")
        if use_steps:
            logits, cache = pre.fn(params, tokens, cache)
            step, _ = dec.fn(params, tokens[:, :1], cache)
        else:
            with torch.no_grad():
                logits, cache = model.prefill(params, cfg, tokens, cache)
                step, _ = model.decode_step(params, cfg, tokens[:, :1], cache)
        outs.append((logits, step))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_train_step_bundle_lays_out_its_arguments():
    cfg = smoke_config(get_arch("pixtral-12b"))
    bundle = steps.build_train_step(cfg, None, SHAPES["train_4k"])
    pshape, oshape, batch = bundle.arg_shapes
    assert all(p.device.type == "meta" for p in tree_leaves(pshape))
    assert [m.shape for m in tree_leaves(oshape["m"])] == [
        p.shape for p in tree_leaves(pshape)]
    assert batch["embeds"].shape == (256, cfg.n_frontend_tokens,
                                     cfg.frontend_dim)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "l": [torch.tensor(3.5, dtype=torch.bfloat16)]}
    for step in (10, 20, 30):
        mgr.save(step, tree_map(lambda x: x + step, tree))
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    got = mgr.restore(30, tree)
    assert list(got) == ["a", "b", "l"]
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3) + 30)
    assert got["b"]["c"].dtype == torch.int32
    assert got["l"][0].dtype == torch.bfloat16 and float(got["l"][0]) == 33.5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_keeps_bf16_leaves_exactly(tmp_path):
    x = torch.randn(257, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x})
    got = mgr.restore(1, {"x": torch.zeros_like(x)})["x"]
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


@pytest.mark.parametrize("bad", ["shape", "count"])
def test_checkpoint_mismatch_rejected(tmp_path, bad):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros((2, 3)), "b": torch.zeros(3)})
    like = ({"w": torch.zeros((3, 2)), "b": torch.zeros(3)} if bad == "shape"
            else {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape" if bad == "shape"
                       else "leaves"):
        mgr.restore(1, like)


def test_checkpoint_manifest_is_the_reference_format(tmp_path):
    """The same tree saved by both managers: the same manifest, the same
    leaves under the same names."""
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "opt": {"step": np.int32(5),
                      "m": rng.standard_normal(4).astype(np.float32)},
              "b": np.arange(3, dtype=np.int32)}
    JCheckpointManager(str(tmp_path / "j")).save(
        7, jax.tree_util.tree_map(jnp.asarray, arrays))
    CheckpointManager(str(tmp_path / "p")).save(
        7, tree_map(lambda a: torch.from_numpy(np.array(a)), arrays))
    man = [json.load(open(tmp_path / d / "step_0000000007" / "manifest.json"))
           for d in ("j", "p")]
    assert man[0] == man[1]
    with np.load(tmp_path / "j" / "step_0000000007" / "leaves.npz") as a, \
            np.load(tmp_path / "p" / "step_0000000007" / "leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[f], b[f]) for f in a.files)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_token_pipeline_is_a_pure_function_of_seed_and_step():
    pipe = TokenPipeline(512, 4, 32, seed=3)
    a, b = pipe.batch_at(5), TokenPipeline(512, 4, 32, seed=3).batch_at(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], pipe.batch_at(6)["tokens"])
    assert not torch.equal(a["tokens"],
                           TokenPipeline(512, 4, 32, seed=4).batch_at(5)[
                               "tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 32)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 511


@pytest.mark.parametrize("t,m,hi", [(8, 512, 4096), (4, 1000, 64),
                                    (16, 256, 100_000)])
def test_smms_length_bucketing_matches_reference(t, m, hi):
    """Order, bucket ids and the report's fields, bitwise; short
    lengths give many ties, long ones ties the 1e-6 tie-break cannot
    separate in float32."""
    lengths = np.random.default_rng(t).integers(1, hi, t * m)
    jorder, jbucket, jrep = jbucketing(lengths, t)
    order, bucket, rep = smms_length_bucketing(lengths, t, device="cpu")
    assert np.array_equal(order, np.asarray(jorder))
    assert np.array_equal(bucket, jbucket)
    assert np.array_equal(np.asarray(rep.workload), np.asarray(jrep.workload))
    for field in ("k_workload", "k_network", "alpha"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert np.all(np.diff(lengths[order]) >= 0)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(64,)).astype(np.float32),
         "b": {"c": rng.normal(size=(3, 5)).astype(np.float32)}}
    jres = jgc.compress_state_init(g)
    res = gc.compress_state_init(tree_map(torch.from_numpy, g))
    for _ in range(4):
        jdeq, jres = jgc.compress_decompress(
            jax.tree_util.tree_map(jnp.asarray, g), jres)
        deq, res = gc.compress_decompress(tree_map(torch.from_numpy, g), res)
        for got, want in zip(tree_leaves(deq) + tree_leaves(res),
                             jax.tree_util.tree_leaves(jdeq)
                             + jax.tree_util.tree_leaves(jres)):
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [2, 4, 8])
def test_compressed_psum_matches_reference(t):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(t, 3, 40)).astype(np.float32)
    res = (rng.normal(size=(t, 3, 40)) * 0.01).astype(np.float32)
    jout, jres = jax.vmap(lambda xi, ri: jgc.compressed_psum(xi, ri, "i"),
                          axis_name="i")(jnp.asarray(x), jnp.asarray(res))
    tape = CollectiveTape()
    out, new = gc.compressed_psum(torch.from_numpy(x), torch.from_numpy(res),
                                  tape=tape)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(new.numpy(), np.asarray(jres))
    # the int8 rows cross the links, counted once a machine
    stats = roofline.tape_collectives(tape, t, bytes_per_obj=1)
    assert stats.per_kind_bytes == {"all-gather": float(t * 120)}


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def _shape(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_reference(arch, shape):
    cfg, spec = ARCHS[arch], SHAPES[shape]
    got = input_specs(cfg, spec)
    want = jinput_specs(JARCHS[arch], JSHAPES[shape])
    assert set(got) == set(want)
    for name in set(got) - {"cache"}:
        assert got[name].device.type == "meta"
        assert _shape(got[name]) == (tuple(want[name].shape),
                                     str(want[name].dtype)), name
    if "cache" in got:
        periods = got["cache"]["periods"]
        assert len(periods) == cfg.n_periods
        for pos, layer in want["cache"]["periods"].items():
            for name, leaf in layer.items():
                assert _shape(periods[0][pos][name]) == (
                    tuple(leaf.shape[1:]), str(leaf.dtype)), (pos, name)


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-1.5-large-398b",
                                  "pixtral-12b", "dbrx-132b"])
def test_params_shape_matches_reference(arch):
    got = model.params_shape(ARCHS[arch])
    want = jmodel.params_shape(JARCHS[arch])
    assert _shape(got["embed"]) == (tuple(want["embed"].shape),
                                    str(want["embed"].dtype))
    assert len(got["periods"]) == ARCHS[arch].n_periods
    flat = jax.tree_util.tree_flatten_with_path(want["periods"])[0]
    for path, leaf in flat:
        node = got["periods"][0]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape[1:])
        assert node.device.type == "meta"


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    terms = roofline.RooflineTerms(flops=989e12, hbm_bytes=3.35e12 / 2,
                                   coll_bytes=0.0, model_flops=989e12)
    assert terms.t_compute == 1.0 and terms.t_memory == 0.5
    assert terms.dominant == "compute"
    assert terms.roofline_fraction(1) == 1.0


@pytest.mark.parametrize("rows,n", [(1, 1), (64, 65536), (8, 1000),
                                    (3, 70000)])
def test_kernel_cost_bytes_match_reference(rows, n):
    for kind, kw in (("bitonic", {}), ("bitonic", {"dtype_bytes": 2}),
                     ("radix", {}), ("radix", {"key_bits": 16,
                                               "radix_bits": 8}),
                     ("merge", {})):
        got = getattr(roofline.KernelCost, kind)(rows, n, **kw)
        want = getattr(jroofline.KernelCost, kind)(rows, n, **kw)
        assert (got.kernel, got.bytes_hbm) == (want.kernel, want.bytes_hbm)
        assert got.t_memory == got.bytes_hbm / 3.35e12
        row = got.row(1e-3, label="x")
        assert row["bytes_hbm"] == round(want.bytes_hbm)
        assert row["label"] == "x"


@pytest.mark.parametrize("t,m", [(64, 65536), (16, 1000), (12, 4096),
                                 (2, 100)])
@pytest.mark.parametrize("topology", ["flat", "staged"])
def test_exchange_stage_bytes_match_reference(t, m, topology):
    for chunks in (1, 2, 3):
        got = roofline.exchange_stage_bytes(t, m, topology=topology,
                                            cap_factor=1.7,
                                            overlap_chunks=chunks)
        want = jroofline.exchange_stage_bytes(t, m, topology=topology,
                                              cap_factor=1.7,
                                              overlap_chunks=chunks)
        assert [(s.name, s.fanin, s.receive_bytes) for s in got] == [
            (s.name, s.fanin, s.receive_bytes) for s in want]
        assert all(s.t_link == s.receive_bytes / 450e9 for s in got)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_reference(arch):
    for name in SHAPES:
        assert roofline.model_flops(ARCHS[arch], SHAPES[name]) == \
            jroofline.model_flops(JARCHS[arch], JSHAPES[name])


def test_extrapolate_matches_reference():
    c1 = {"flops": 10.0, "bytes accessed": 7.0}
    c2 = {"flops": 16.5, "bytes accessed": 9.25}
    for n in (1, 2, 18, 126):
        assert roofline.extrapolate(c1, c2, 3.0, 5.0, n) == \
            jroofline.extrapolate(c1, c2, 3.0, 5.0, n)
    assert roofline.extrapolate({}, {}, 0.0, 0.0, 4) == (0.0, 0.0, 0.0)


def test_tape_collectives_count_the_busiest_machine():
    tape = CollectiveTape()
    with tape.phase("sample"):
        tape.all_gather(torch.zeros((4, 3)))
    with tape.phase("shuffle"):
        tiles = torch.zeros((4, 4, 2))
        tiles[0, 1] = 9.0                   # PAD-marked slots land nowhere
        tape.all_to_all(tiles, pad=5.0)
    stats = roofline.tape_collectives(tape, 4)
    assert stats.per_kind_bytes == {"all-gather": 12 * 4.0,
                                    "all-to-all": 8 * 4.0}
    assert stats.total == 80.0
