"""The port's MoE layer and MoE decoders against the reference, on the CPU.

Same numpy-seeded inputs and the reference's own weights
(``repro.models.moe.init_moe``, ``repro.models.model.init_params``
carried over by ``models.convert.params_from_reference``) through both
packages:

* ``plan_slots`` bitwise (the reference's cases, ties, a brute-force
  optimum), the routing ids bitwise and ``MoEStats`` bitwise;
* ``moe_layer`` in ``capacity`` and ``alpha_k`` (even and random
  replicas, the reference's ``jax.random.randint`` draws injected;
  ``groups`` > 1 and its fallback): y within the reference's own bound
  for its layer against a dense oracle, rtol = atol = 2e-4 on float32;
* the smoke configurations of granite-moe-3b-a800m and dbrx-132b:
  ``prefill``, teacher-forced ``decode_step`` logits within 2e-3 (the
  bound of ``test_torch_serve.py``: the two attention paths sum in
  another order) and ``generate``'s tokens equal.
"""
import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serve.engine import generate as jgenerate
from repro_torch.configs import ARCHS, MoEConfig, smoke_config
from repro_torch.models import model, moe
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import generate

TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's layer, jitted as its own tests run it (eagerly, its
# associative_scan prefix dispatches op by op)
jmoe_layer = jax.jit(jmoe.moe_layer, static_argnames=("cfg", "act", "groups"))
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
MOE_ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]


def port_params(p):
    return {name: torch.from_numpy(np.array(w)) for name, w in p.items()}


def layer_inputs(d=32, e=8, k=2, tokens=512, hot=True, seed=0, **cfg_kw):
    """The reference's MoE parameters (a hot expert 0 when ``hot``, as
    tests/test_moe_dispatch.py biases it), numpy tokens, both configs."""
    kw = dict(num_experts=e, top_k=k, d_ff_expert=16, **cfg_kw)
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    p = jmoe.init_moe(jax.random.key(seed), d, jcfg, jnp.float32)
    if hot:
        router = np.array(p["router"]) * 0.01
        router[:, 0] += np.linspace(0.3, 0.8, d)
        p["router"] = jnp.asarray(router)
    x = np.random.default_rng(seed + 5).standard_normal(
        (tokens, d)).astype(np.float32)
    return p, x, jcfg, cfg


# ---------------------------------------------------------------------------
# plan_slots and routing
# ---------------------------------------------------------------------------

def _random_counts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 1000, size=4) for _ in range(4)]


@pytest.mark.parametrize("counts, r", [
    ([1000, 10, 10, 10], 3), ([600, 600, 10, 10], 4), ([5, 5, 5, 5], 6),
    ([0, 0, 0, 7], 2), ([7, 3, 3, 0, 9, 9], 5), ([100], 3),
    ([0, 0, 0, 0], 3), ([6, 12, 24, 3, 0], 7), ([24, 12, 6], 0)]
    + [(c, 3) for c in _random_counts()])
def test_plan_slots_matches_reference(counts, r):
    counts = np.asarray(counts, np.int32)
    want = jmoe.plan_slots(jnp.asarray(counts), len(counts), r)
    got = moe.plan_slots(torch.from_numpy(counts), len(counts), r)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plan_slots_greedy_matches_bruteforce():
    """The greedy split is optimal for min max_e c_e / r_e: against every
    allocation of R extra slots to E experts."""
    e, r = 4, 3
    rng = np.random.default_rng(11)
    for _ in range(8):
        counts = rng.integers(1, 1000, size=e).astype(np.int32)
        _, replicas, _ = moe.plan_slots(torch.from_numpy(counts), e, r)
        greedy = float(np.max(counts / replicas.numpy()))
        best = min(
            float(np.max(counts / (1 + np.bincount(alloc, minlength=e))))
            for alloc in itertools.combinations_with_replacement(range(e), r))
        assert greedy <= best + 1e-6


@pytest.mark.parametrize("hot, k, e", [(True, 2, 8), (False, 8, 40),
                                       (False, 1, 4)])
def test_routing_ids_match_reference(hot, k, e):
    p, x, _, _ = layer_inputs(d=64, e=e, k=k, tokens=1024, hot=hot, seed=3)
    logits = jnp.einsum("td,de->te", jnp.asarray(x), p["router"])
    want_vals, want_ids = jax.lax.top_k(logits, k)
    vals, ids = moe.route(torch.from_numpy(x), port_params(p)["router"], k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), **TOL)
    # ties: the lower expert first, as lax.top_k
    tied = torch.tensor([[1.0, 3.0, 3.0, 1.0, 3.0]])
    _, tie_ids = moe.route(tied, torch.eye(5), 4)
    assert tie_ids.tolist() == [[1, 2, 4, 0]]


# ---------------------------------------------------------------------------
# moe_layer
# ---------------------------------------------------------------------------

LAYER_CASES = {
    "capacity_hot": dict(dispatch="capacity", capacity_factor=1.25),
    "capacity_k1": dict(dispatch="capacity", k=1),
    "alpha_k_hot": dict(dispatch="alpha_k", extra_slots=8),
    "alpha_k_uniform": dict(dispatch="alpha_k", extra_slots=4, hot=False),
    "alpha_k_random": dict(dispatch="alpha_k", extra_slots=8,
                           replica_choice="random"),
    "alpha_k_groups": dict(dispatch="alpha_k", extra_slots=4, groups=4),
    "alpha_k_pinned_cap": dict(dispatch="alpha_k", extra_slots=2,
                               alpha_k_cap=0.5),
    "capacity_groups": dict(dispatch="capacity", groups=2, hot=False),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_reference(case):
    kw = dict(LAYER_CASES[case])
    groups = kw.pop("groups", 1)
    p, x, jcfg, cfg = layer_inputs(**kw)
    rng = draws = None
    if cfg.replica_choice == "random":
        rng = jax.random.key(7)
        k = cfg.top_k
        draws = torch.from_numpy(np.array(jax.random.randint(
            rng, (groups, x.shape[0] // groups * k), 0, 1 << 30)))
    want_y, want = jmoe_layer(p, jnp.asarray(x), cfg=jcfg, groups=groups,
                              rng=rng)
    y, got = moe.moe_layer(port_params(p), torch.from_numpy(x), cfg,
                           groups=groups, draws=draws)
    assert int(got.dropped) == int(want.dropped)
    assert int(got.max_slot_load) == int(want.max_slot_load)
    assert float(got.mean_slot_load) == float(want.mean_slot_load)
    np.testing.assert_array_equal(got.slot_load.numpy(),
                                  np.asarray(want.slot_load))
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    if case.startswith("capacity_hot"):
        assert int(got.dropped) > 0       # the hot expert overflows


def test_moe_layer_groups_fallback_warns_like_the_reference():
    p, x, jcfg, cfg = layer_inputs(tokens=128, extra_slots=4, hot=False)
    with pytest.warns(UserWarning, match="does not divide"):
        y, stats = moe.moe_layer(port_params(p), torch.from_numpy(x), cfg,
                                 groups=3)
    want_y, want = jmoe_layer(p, jnp.asarray(x), cfg=jcfg, groups=1)
    np.testing.assert_array_equal(stats.slot_load.numpy(),
                                  np.asarray(want.slot_load))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)


def test_moe_layer_bf16_tokens_run_in_bf16():
    """The serving dtype path: bf16 tokens and weights give bf16 rows
    and outputs, the router still in float32, so the routing is the
    float32 layer's on the same values; the outputs agree within bf16's
    rounding of the rows, the products and the sum (5e-2: a few bf16
    ulps of O(1) values)."""
    p, x, _, cfg = layer_inputs(extra_slots=4, hot=False)
    params = {name: (w if name == "router" else w.to(torch.bfloat16))
              for name, w in port_params(p).items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, stats = moe.moe_layer(params, xb, cfg)
    y32, stats32 = moe.moe_layer(
        {name: w.float() for name, w in params.items()}, xb.float(), cfg)
    assert y.dtype == torch.bfloat16 and int(stats.dropped) == 0
    assert torch.equal(stats.slot_load, stats32.slot_load)
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_random_replica_choice_requires_rng_or_draws():
    p, x, _, cfg = layer_inputs(tokens=64, e=4, k=1, extra_slots=4,
                                replica_choice="random")
    with pytest.raises(ValueError, match="rng"):
        moe.moe_layer(port_params(p), torch.from_numpy(x), cfg)
    _, stats = moe.moe_layer(port_params(p), torch.from_numpy(x), cfg,
                             rng=torch.Generator().manual_seed(7))
    assert int(stats.slot_load.sum()) == 64


def test_moe_layer_rejects_cluster_dispatch():
    p, x, _, cfg = layer_inputs(tokens=32, dispatch="cluster")
    with pytest.raises(ValueError, match="cluster"):
        moe.moe_layer(port_params(p), torch.from_numpy(x), cfg)


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------

B, PROMPT, STEPS = 2, 48, 4


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    jcfg = jsmoke_config(JARCHS[request.param])
    cfg = smoke_config(ARCHS[request.param])
    jparams = jmodel.init_params(jcfg, jax.random.key(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_reference(tree, cfg, device="cpu")
    return cfg, params, jcfg, jparams, tree


def test_moe_params_carry_over(moe_pair):
    cfg, params, _, _, tree = moe_pair
    assert cfg.moe is not None and cfg.n_periods == 2
    for i in range(cfg.n_periods):
        block = params["periods"][i]["0"]
        assert "mlp" not in block and set(block["moe"]) == {
            "router", "w_gate", "w_up", "w_down"}
        assert block["moe"]["router"].dtype == torch.float32
        for name, w in block["moe"].items():
            np.testing.assert_array_equal(
                w.numpy(), tree["periods"]["0"]["moe"][name][i])
    mine = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = model.init_params(dataclasses.replace(
        cfg, param_dtype=torch.bfloat16), torch.Generator().manual_seed(0),
        "cpu")["periods"][0]["0"]["moe"]
    assert got["router"].dtype == torch.float32
    assert got["w_gate"].dtype == torch.bfloat16
    assert {n: tuple(w.shape) for n, w in mine["periods"][1]["0"][
        "moe"].items()} == {n: tuple(w.shape) for n, w in params["periods"][
            1]["0"]["moe"].items()}


def test_moe_model_matches_reference(moe_pair):
    cfg, params, jcfg, jparams, _ = moe_pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, B, PROMPT + STEPS)
    want, jcache = jax.jit(lambda p, t, c: jmodel.prefill(p, jcfg, t, c))(
        jparams, jnp.asarray(tokens), jcache)
    cache = model.init_cache(cfg, B, PROMPT + STEPS, device="cpu")
    got, cache = model.prefill(params, cfg, torch.from_numpy(tokens), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    step = jax.jit(lambda p, t, c: jmodel.decode_step(p, jcfg, t, c))
    for i in range(STEPS):
        want, jcache = step(jparams, jnp.asarray(teacher[:, i:i + 1]), jcache)
        got, cache = model.decode_step(
            params, cfg, torch.from_numpy(teacher[:, i:i + 1]), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
    np.testing.assert_array_equal(
        generate(params, cfg, tokens, STEPS, device="cpu"),
        np.asarray(jgenerate(jparams, jcfg, jnp.asarray(tokens), STEPS)))
