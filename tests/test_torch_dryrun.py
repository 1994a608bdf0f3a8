"""The port's dry run on the fake 256-rank production mesh.

``python -m repro_torch.launch.dryrun`` in subprocesses (it initialises
a fake default process group of 256 ranks, which must not live in the
test process): gemma-2b's train_4k cut to one period with
``--override`` (the full depth traces in ~20 s on the CPU) and
granite-moe-3b-a800m's decode_32k at full depth, each ``ok`` with
per-device ``arguments_bytes`` equal to the bytes worked out here from
the reference's own PartitionSpecs on an ``AbstractMesh`` and its leaf
shapes (the reference's cache position, a device scalar there, is a
host int in the port); a cell the reference skips gives its
``skip_reason``; ``--no-roofline`` leaves ``roofline`` out.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import skip_reason as jskip_reason
from repro.models import model as jmodel
from repro.sharding.specs import make_rules as jmake_rules

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SIZES = {"data": 16, "model": 16}


def _bytes(shape, dtype, spec) -> int:
    n = 1
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= math.ceil(size / math.prod(SIZES[a] for a in axes))
    return n * np.dtype(dtype).itemsize


def _tree_bytes(shapes, specs, skip=()) -> int:
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    total = 0
    for (path, leaf), spec in zip(leaves, spec_leaves):
        if str(getattr(path[-1], "key", path[-1])) in skip:
            continue
        total += _bytes(leaf.shape, leaf.dtype, spec)
    return total


def reference_argument_bytes(arch, shape_name, overrides=None) -> int:
    """One device's argument bytes of the reference's step on (16, 16):
    parameters, and AdamW's moments, step and the batch (train), or the
    tokens and the cache without its position (serving)."""
    cfg = dataclasses.replace(JARCHS[arch], **(overrides or {}))
    shape = JSHAPES[shape_name]
    rules = jmake_rules(AbstractMesh((16, 16), ("data", "model")), cfg)
    pshape = jmodel.params_shape(cfg)
    pspecs = rules.param_specs(pshape)
    total = _tree_bytes(pshape, pspecs)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        f32 = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, np.float32), pshape)
        total += 2 * _tree_bytes(f32, pspecs) + 4          # m, v, step
        total += 2 * _bytes((b, s), np.int32, rules.batch_spec(b))
        return total
    total += _bytes((b, 1 if shape.kind == "decode" else s), np.int32,
                    rules.batch_spec(b))
    cache = jax.eval_shape(lambda: jmodel.init_cache(cfg, b, s))
    return total + _tree_bytes(cache, rules.cache_specs(cache),
                               skip=("pos",))


def _dryrun(tmp_path, *args) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp_path)], env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    name = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(name) == 1, name
    with open(tmp_path / name[0]) as f:
        return json.load(f)


@pytest.mark.parametrize("arch, shape, overrides, roofline", [
    ("gemma-2b", "train_4k", {"n_layers": 1}, True),
    ("granite-moe-3b-a800m", "decode_32k", None, False),
])
def test_dryrun_cell_has_the_references_argument_bytes(
        tmp_path, arch, shape, overrides, roofline):
    args = ["--arch", arch, "--shape", shape]
    if overrides:
        args += ["--override", json.dumps(overrides)]
    if not roofline:
        args.append("--no-roofline")
    rec = _dryrun(tmp_path, *args)
    assert rec["status"] == "ok", rec
    mem = rec["memory_per_device"]
    assert mem["arguments_bytes"] == reference_argument_bytes(
        arch, shape, overrides)
    assert mem["output_bytes"] > 0 and mem["fits_80GiB_hbm"] is True
    assert mem["peak_bytes"] >= mem["arguments_bytes"]
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert rec["collectives_prod_bytes"]["all-reduce"] > 0
    assert rec["compile_s"] >= 0
    assert ("roofline" in rec) == roofline
    if roofline:
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["roofline"]["model_flops"] > 0


def test_dryrun_skips_what_the_reference_skips(tmp_path):
    rec = _dryrun(tmp_path, "--arch", "gemma-2b", "--shape", "long_500k")
    assert rec["status"] == "skip"
    assert rec["skip_reason"] == jskip_reason(JARCHS["gemma-2b"],
                                              JSHAPES["long_500k"])
