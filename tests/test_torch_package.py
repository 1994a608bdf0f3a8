"""The port as a package: what it imports, where it runs, what it refuses."""
import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro_torch
from repro import cluster as jcluster
from repro_torch import cluster
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops


def test_port_imports_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import sys
        import repro_torch
        import repro_torch.cluster, repro_torch.core, repro_torch.data
        import repro_torch.kernels.ops, repro_torch.kernels.ref
        import repro_torch.kernels.cuda, repro_torch.cluster.api
        import repro_torch.profile_port, repro_torch.workloads
        import repro_torch.configs, repro_torch.models, repro_torch.serve
        import repro_torch.models.model, repro_torch.models.convert
        import repro_torch.serve.engine, repro_torch.kernels.flash_attention
        import repro_torch.launch, repro_torch.obs, repro_torch.planner
        import repro_torch.serve.query, repro_torch.serve.batching
        import repro_torch.obs.export
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print(",".join(bad))
    """)
    src = str(__import__("pathlib").Path(repro_torch.__file__).parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": src},
                         timeout=120)
    assert out.stdout.strip() == ""


def test_query_engine_imports_neither_jax_nor_the_models():
    """``repro_torch.serve.query`` alone: no jax, no reference, and the
    LM stack stays unloaded (``serve.generate`` is lazy)."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.serve.query
        from repro_torch.serve import QueryEngine, EngineReplicas
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro.")
                     or m.startswith("repro_torch.models"))
        print(",".join(bad))
    """)
    src = str(__import__("pathlib").Path(repro_torch.__file__).parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": src},
                         timeout=120)
    assert out.stdout.strip() == ""


def test_front_door_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((2, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.sort(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.sort(x, device="cuda")
    (keys, _), _ = cluster.sort(x, device="cpu")
    assert keys.device.type == "cpu"


def _tables():
    keys = np.arange(8, dtype=np.int32) % 3
    rows = np.arange(8, dtype=np.int32)
    return keys, rows, keys, rows


def _unported(entry, change):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import model
    from repro_torch.planner import plan_moe_query
    if entry == "plan_moe_query":
        plan_moe_query(np.zeros((4, 2), np.float32),
                       np.zeros((2, 2), np.float32), t_machines=2,
                       num_experts=2, top_k=1, extra_slots=0)
    else:
        model.check_dense(dataclasses.replace(
            smoke_config(ARCHS[entry]), **change))


@pytest.mark.parametrize("entry, change, item", [
    ("plan_moe_query", None, "A8"),
    ("gemma3-12b", {"moe": MoEConfig(num_experts=4, top_k=1,
                                      d_ff_expert=8)}, "A8"),
    ("gemma3-12b", {"frontend": "vision"}, "A12"),
    ("llama3-405b", {"kv_quant": True}, "A12"),
])
def test_unported_options_name_their_roadmap_item(entry, change, item):
    with pytest.raises(NotImplementedError, match=item):
        _unported(entry, change)


def test_generate_defaults_to_the_card(monkeypatch):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import model
    from repro_torch.serve import generate
    cfg = smoke_config(ARCHS["gemma3-12b"])
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.zeros((1, 4), np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(params, cfg, prompt, max_new_tokens=2)
    out = generate(params, cfg, prompt, max_new_tokens=2, device="cpu")
    assert out.shape == (1, 2) and out.dtype == np.int32


def test_join_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.join(*_tables(), t_machines=2)
    out, _ = cluster.join(*_tables(), t_machines=2, device="cpu")
    assert out.s_rows.device.type == "cpu"
    assert int(out.count.sum()) == 3 * 3 + 3 * 3 + 2 * 2


def test_values_must_align_with_the_keys():
    with pytest.raises(ValueError, match="align"):
        cluster.sort(np.ones((2, 8), np.float32), values=np.ones((2, 7)),
                     device="cpu")


def test_front_door_rejects_a_flat_array():
    with pytest.raises(ValueError, match=r"\(t, m\)"):
        cluster.sort(np.ones(8, np.float32), device="cpu")


def test_rows_past_the_gate_raise_instead_of_falling_back():
    """m = 2^17 keys per machine is past MAX_KERNEL_LANES, where the
    reference falls back to jnp.  The port used to raise there (C10);
    now its own kernels sort it -- the radix family past the bitonic
    tile's reach, the rank merge -- never a library sort, and the keys
    and values are the reference's, bitwise."""
    t, m = 2, 2 * ops.MAX_KERNEL_LANES
    x = np.random.default_rng(8).normal(size=(t, m)).astype(np.float32)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    (want, want_v), want_rep = jcluster.sort(jnp.asarray(x), values=v)
    ops.reset_dispatch_counts()
    (got, got_v), rep = cluster.sort(x, values=v, device="cpu")
    assert {p for _, p in ops.DISPATCH_COUNTS} <= {"plain", "radix-plain"}
    assert ops.DISPATCH_COUNTS[("sort_kv", "radix-plain")] == 1
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(rep.workload, want_rep.workload)


def test_broadcast_small_side_past_the_gate_raises():
    """T as the small side is pair-sorted whole on every machine: past
    2^16 rows the reference falls back to jnp and the port, which used
    to raise (C10), sorts it by the radix family.  The same operands
    give the reference's output: every one of the 2 x 65,537 pairs
    matches, 8 slots a machine hold the first, the rest are dropped."""
    n = ops.MAX_KERNEL_LANES + 1
    keys = np.zeros(n, np.int32)
    args = (keys[:2], keys[:2], keys, keys)
    kw = dict(algorithm="broadcast", small_side="t", t_machines=2,
              out_capacity=8)
    want, want_rep = jcluster.join(*args, **kw)
    got, rep = cluster.join(*args, **kw, device="cpu")
    for field in ("s_rows", "t_rows", "valid", "count", "dropped"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert int(got.count.sum()) == 2 * n
    np.testing.assert_array_equal(rep.workload, want_rep.workload)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensor_past_the_gate_raises(card):
    """The operands that used to raise on the card (C10) -- rows of
    2^17, bf16 keys -- now run the port's kernels there and equal the
    CPU's plain versions; float64 keys still raise."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2 * ops.MAX_KERNEL_LANES, generator=g)
    xb = torch.randn(2, 8, generator=g).bfloat16()
    v = torch.arange(x.numel(), dtype=torch.int32).reshape(x.shape)
    assert torch.equal(ops.sort(x.to(card)).cpu(), ops.sort(x))
    assert torch.equal(ops.sort(xb.to(card)).cpu().view(torch.int16),
                       ops.sort(xb).view(torch.int16))
    (gk, gv), _ = cluster.sort(x.to(card), values=v.to(card))
    (wk, wv), _ = cluster.sort(x, values=v, device="cpu")
    assert torch.equal(gk.cpu(), wk) and torch.equal(gv.cpu(), wv)
    for a, b in zip(ops.sort_kv(x.to(card), v.to(card)), ops.sort_kv(x, v)):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="C10"):
        ops.sort(torch.zeros(2, 8, dtype=torch.float64, device=card))
