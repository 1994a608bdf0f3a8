"""The last of the reference's public API on the port, on the CPU.

Each function the port took over last is held against the reference on
inputs made with numpy from a seed: the paper's k bounds of Theorems 4,
5 and 7 and ``merge_phase_stats`` (exactly), ``interval_pdf``
(bitwise), ``join_size`` (exactly), the radix key bijection through
``ops``, the oracles ``bucketize_ref`` (exactly) and ``attention_ref``
(within 1e-5 of the reference's and of the port's flash plain
version), ``train_input_sharding`` for all ten configurations, and the entry
points whose device now defaults to the card.
"""
import datetime

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS
from repro.core import alpha_k as jalpha_k
from repro.core.boundaries import interval_pdf as jinterval_pdf
from repro.core.localjoin import MASKED_KEY as JMASKED
from repro.core.localjoin import join_size as jjoin_size
from repro.kernels import radix as jradix
from repro.kernels import ref as jref
from repro.launch.steps import train_input_sharding as jtrain_input_sharding
from repro.sharding.specs import make_rules as jmake_rules
from jax.sharding import AbstractMesh
from repro_torch import cluster, core, obs, planner
from repro_torch.cluster import compat
from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.core import MASKED_KEY
from repro_torch.data import scalar_skew_tables, zipf_tables
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import make_staged_mesh, steps
from repro_torch.models import model
from repro_torch.planner import sketch
from repro_torch.sharding import make_rules

GRID_N = (4096, 1 << 16, 4_194_304, 1 << 30)
GRID_T = (2, 8, 16, 64)
GRID_SIGMA = (0.5, 1.0, 2.5, 127.88, 1e4)


@pytest.fixture(autouse=True)
def _reset_port_state():
    def reset():
        planner.clear_plan_cache()
        cluster.reset_default_pool()
        ops.reset_dispatch_counts()
        obs.reset_registry()
    reset()
    yield
    reset()


# ---------------------------------------------------------------------------
# core/alpha_k.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", GRID_T)
@pytest.mark.parametrize("n", GRID_N)
def test_sort_k_bounds_are_the_references(n, t):
    assert core.terasort_k_bound(n, t) == jalpha_k.terasort_k_bound(n, t)
    for r in (1, 2, 3):
        assert core.smms_k_bound(n, t, r) == jalpha_k.smms_k_bound(n, t, r)


@pytest.mark.parametrize("sigma", GRID_SIGMA)
@pytest.mark.parametrize("t", GRID_T)
def test_join_k_bounds_are_the_references(t, sigma):
    assert core.statjoin_k_bound(t, sigma) == jalpha_k.statjoin_k_bound(
        t, sigma)
    assert core.randjoin_k_bound(t, sigma) == jalpha_k.randjoin_k_bound(
        t, sigma)


def test_the_bounds_at_the_smoke_runs_sizes():
    """The numbers chip_smoke.py's alpha_k phase holds its t = 64 paths
    to: Theorem 2 (r = 2) and Theorem 4 at n = 64 x 65,536."""
    assert core.smms_k_bound(64 * 65536, 64, 2) == 2.125
    assert core.terasort_k_bound(64 * 65536, 64) == 5.0625


def test_merge_phase_stats_is_the_references():
    rng = np.random.default_rng(0)
    stats = [{"name": f"p{i}", "sent": rng.integers(0, 99, 8),
              "received": rng.integers(0, 99, 8).astype(np.float32)}
             for i in range(3)]
    got, want = core.merge_phase_stats(stats), jalpha_k.merge_phase_stats(
        stats)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        for field in ("sent", "received", "net"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# core/boundaries.py:interval_pdf, core/localjoin.py:join_size
# ---------------------------------------------------------------------------

def _lam_rows(kind: str, t: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        lam = rng.standard_normal((t, s + 1)).astype(np.float32) * 1e3
    else:                   # tied samples: zero widths hit the 1e-30 floor
        lam = rng.integers(0, 4, (t, s + 1)).astype(np.float32)
    return np.sort(lam, axis=1)


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("t,m,r", [(4, 1024, 2), (8, 4096, 3), (16, 500, 1)])
def test_interval_pdf_is_bitwise_the_references(kind, t, m, r):
    s = r * t
    lam = _lam_rows(kind, t, s, seed=t * m + r)
    got = core.interval_pdf(torch.from_numpy(lam), m, s).numpy()
    want = np.asarray(jinterval_pdf(jnp.asarray(lam), m, s))
    assert got.dtype == want.dtype and got.shape == (t, s + 1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _masked(keys: np.ndarray, seed: int) -> np.ndarray:
    keys = np.asarray(keys, np.int32).copy()
    rng = np.random.default_rng(seed)
    keys[rng.random(len(keys)) < 0.1] = MASKED_KEY
    return keys


JOIN_TABLES = {
    "zipf": lambda: zipf_tables(3000, 2500, theta=0.8, seed=4, domain=120),
    "scalar_skew": lambda: scalar_skew_tables(4000, 400, 100, seed=1),
}


@pytest.mark.parametrize("case", sorted(JOIN_TABLES))
def test_join_size_is_the_references(case):
    s, t = JOIN_TABLES[case]()
    s, t = _masked(s, 5), _masked(t, 6)
    assert MASKED_KEY == int(JMASKED)
    got = core.join_size(torch.from_numpy(s), torch.from_numpy(t))
    want = jjoin_size(jnp.asarray(s), jnp.asarray(t))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(want)
    real_s, real_t = s[s != MASKED_KEY], t[t != MASKED_KEY]
    keys, counts = np.unique(real_t, return_counts=True)
    lookup = dict(zip(keys.tolist(), counts.tolist()))
    assert int(got) == sum(lookup.get(k, 0) for k in real_s.tolist())


# ---------------------------------------------------------------------------
# kernels/ops.py and kernels/ref.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_key_bits_round_trip_through_ops(dtype):
    rng = np.random.default_rng(3)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 4096,
                                          dtype=np.int64).astype(np.int32))
        jx = jnp.asarray(x.numpy())
    else:
        bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
        x = torch.from_numpy(bits.view(np.float32))
        if dtype == torch.bfloat16:
            x = (torch.from_numpy((bits >> 16).astype(np.uint16)
                                  .view(np.int16)).view(torch.bfloat16))
            jx = jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
        else:
            jx = jnp.asarray(x.numpy())
    assert ops.key_to_bits is not None and ops.bits_to_key is not None
    carrier = ops.key_to_bits(x)
    np.testing.assert_array_equal(carrier.numpy().view(np.uint32),
                                  np.asarray(jradix.key_to_bits(jx)))
    back = ops.bits_to_key(carrier, dtype)
    width = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(back.view(width), x.view(width))


@pytest.mark.parametrize("t", [2, 7, 64])
def test_bucketize_ref_is_the_references(t):
    rng = np.random.default_rng(t)
    keys = rng.standard_normal(5000).astype(np.float32)
    bounds = np.sort(rng.standard_normal(t - 1).astype(np.float32))
    keys[:50] = np.repeat(bounds, 50)[:50] if t > 1 else keys[:50]
    ids, counts = ref.bucketize_ref(torch.from_numpy(keys),
                                    torch.from_numpy(bounds), t)
    jids, jcounts = jref.bucketize_ref(jnp.asarray(keys), jnp.asarray(bounds),
                                       t)
    assert ids.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
@pytest.mark.parametrize("sq", [12, 1])
def test_attention_ref_is_the_references_and_the_flash_plain(causal, window,
                                                             sq):
    rng = np.random.default_rng(sq + (window or 0))
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# launch/steps.py:train_input_sharding
# ---------------------------------------------------------------------------

class StandInMesh:
    """A mesh no process holds: its shape and axis names."""

    def __init__(self, shape, names):
        self.shape, self.axis_names = tuple(shape), tuple(names)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_input_sharding_is_the_references(arch):
    shape, names = (16, 16), ("data", "model")
    rules = make_rules(StandInMesh(shape, names), ARCHS[arch])
    jrules = jmake_rules(AbstractMesh(shape, names), JARCHS[arch])
    for batch in (256, 16, 4):
        got = steps.train_input_sharding(ARCHS[arch], rules, batch)
        want = jtrain_input_sharding(JARCHS[arch], jrules, batch)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the card as every entry point's default
# ---------------------------------------------------------------------------

def _entry_points(device):
    x = np.random.default_rng(0).random((4, 64)).astype(np.float32)
    s, t = zipf_tables(256, 256, theta=0.5, seed=1, domain=40)
    router = np.random.default_rng(1).standard_normal((8, 4)).astype(
        np.float32)
    xm = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    cfg = smoke_config(get_arch("gemma-2b"))
    return {
        "plan_sort_query": lambda: planner.plan_sort_query(
            x, t=4, device=device),
        "plan_join_query": lambda: planner.plan_join_query(
            s, t, t_machines=4, device=device),
        "plan_moe_query": lambda: planner.plan_moe_query(
            xm, router, t_machines=4, num_experts=4, top_k=1, extra_slots=2,
            device=device),
        "profile_join_tables": lambda: sketch.profile_join_tables(
            np.asarray(s, np.int32), np.asarray(t, np.int32), 4,
            cluster.BatchedSubstrate(4), masked=MASKED_KEY, device=device),
        "init_cache": lambda: model.init_cache(cfg, 2, 16, device=device),
    }


@pytest.mark.parametrize("entry", ["plan_sort_query", "plan_join_query",
                                   "plan_moe_query", "profile_join_tables",
                                   "init_cache"])
def test_entry_point_defaults_to_the_card(entry, monkeypatch):
    run = _entry_points("cpu")[entry]
    out = run()
    assert out is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _entry_points(None)[entry]()


def test_init_cache_meta_lays_out_shapes_only():
    cfg = smoke_config(get_arch("gemma-2b"))
    cache = model.init_cache(cfg, 2, 16, device="meta")
    assert cache["periods"][0]["0"]["k"].device.type == "meta"


def test_meshes_default_to_the_groups_device_type(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        assert compat.make_mesh((1,), ("i",)).device_type == "cpu"
        assert make_staged_mesh(1).device_type == "cpu"
    finally:
        dist.destroy_process_group()


def test_meshes_on_an_nccl_group_default_to_the_card(tmp_path, monkeypatch):
    """The repair itself: under NCCL the meshes built with no device
    type are "cuda" meshes (a (1,) Gloo group stands in, its backend
    read as NCCL, and a stub records what DeviceMesh was asked for)."""
    import torch.distributed.device_mesh as device_mesh

    class StubMesh:
        def __init__(self, device_type, mesh, mesh_dim_names=None):
            self.device_type = device_type
            self.mesh_dim_names = mesh_dim_names

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(device_mesh, "DeviceMesh", StubMesh)
        assert compat.make_mesh((1,), ("i",)).device_type == "cuda"
        assert make_staged_mesh(1).device_type == "cuda"
        assert make_staged_mesh(1, device_type="cpu").device_type == "cpu"
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
