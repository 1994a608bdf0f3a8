"""The port's serving path on the reference's remaining configurations,
against the reference model, on the CPU in float32.

pixtral-12b (the vision front end: patch embeddings through
``frontend_proj``, prepended to the prompt), mamba2-130m (Mamba-2
layers only, tied embeddings), jamba-1.5-large-398b (a period of one
attention and seven mamba layers, MoE every second layer) and gemma-2b
with the int8 KV cache (``kv_quant``), each at its smoke configuration:
the reference's ``init_params`` draws the weights and
``models.convert.params_from_reference`` carries them over.  On the
same numpy-seeded prompt of 48 tokens (past 16: the port's prefill
goes through the flash-attention kernel's plain version, the
reference's through its blockwise scan; past the smoke SSM chunk of
32, and not a multiple of it):

* the last-position ``prefill`` logits agree;
* each of 4 teacher-forced ``decode_step`` logits agrees (dense rows
  over the cache, dequantized where it is int8; a mamba layer's
  recurrent step);
* ``generate`` gives the reference's tokens.

Bound: rtol = atol = 2e-3, as tests/test_torch_serve.py (the two
attention paths sum in another order in float32; so do the SSD scan's
contractions).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke_config
from repro.models import model as jmodel
from repro.serve.engine import generate as jgenerate
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import model
from repro_torch.models.convert import params_from_reference, tree_map
from repro_torch.serve import generate

# name -> (architecture, change to its smoke configuration)
VARIANTS = {"pixtral-12b": ("pixtral-12b", {}),
            "mamba2-130m": ("mamba2-130m", {}),
            "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
            "gemma-2b-int8-cache": ("gemma-2b", {"kv_quant": True})}
B, PROMPT, STEPS = 2, 48, 4
TOL = dict(rtol=2e-3, atol=2e-3)


def configs(name):
    arch, change = VARIANTS[name]
    return (dataclasses.replace(smoke_config(ARCHS[arch]), **change),
            dataclasses.replace(jsmoke_config(JARCHS[arch]), **change))


def inputs(cfg, seed=0):
    """The prompt, and the front end's embeddings where there is one."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    embeds = None
    if cfg.frontend == "vision":
        embeds = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return tokens, embeds


def front(cfg) -> int:
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """(port cfg, port params, reference cfg, reference params, the
    reference's prefill logits, decode logits and cache after prefill,
    the teacher tokens)."""
    cfg, jcfg = configs(request.param)
    jparams = jmodel.init_params(jcfg, jax.random.key(1))
    params = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   cfg, "cpu")
    tokens, embeds = inputs(cfg)
    teacher = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    cache = jmodel.init_cache(jcfg, B, PROMPT + front(cfg) + STEPS)
    logits, cache = jax.jit(
        lambda p, t, c, e: jmodel.prefill(p, jcfg, t, c, embeds=e))(
            jparams, jnp.asarray(tokens), cache,
            None if embeds is None else jnp.asarray(embeds))
    prefilled = jax.tree_util.tree_map(np.asarray, cache)
    step = jax.jit(lambda p, t, c: jmodel.decode_step(p, jcfg, t, c))
    steps = []
    for i in range(STEPS):
        out, cache = step(jparams, jnp.asarray(teacher[:, i:i + 1]), cache)
        steps.append(np.asarray(out))
    return (cfg, params, jcfg, jparams, np.asarray(logits), steps, prefilled,
            teacher)


def run_port(cfg, params, teacher, device="cpu"):
    tokens, embeds = inputs(cfg)
    cache = model.init_cache(cfg, B, PROMPT + front(cfg) + STEPS,
                             device=device)
    logits, cache = model.prefill(
        params, cfg, torch.from_numpy(tokens).to(device), cache,
        None if embeds is None else torch.from_numpy(embeds).to(device))
    prefilled = tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, cache)
    steps = []
    for i in range(STEPS):
        out, cache = model.decode_step(
            params, cfg, torch.from_numpy(teacher[:, i:i + 1]).to(device),
            cache)
        steps.append(out)
    return logits, steps, prefilled


def test_prefill_logits_match_reference(pair):
    cfg, params, _, _, want, _, _, teacher = pair
    ops.reset_dispatch_counts()
    got, _, cache = run_port(cfg, params, teacher)
    assert got.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    attn_layers = sum(cfg.kind(p) != "mamba" for p in range(cfg.period))
    assert ops.DISPATCH_COUNTS[("flash_attention", "plain")] == \
        attn_layers * cfg.n_periods
    assert cache["pos"] == PROMPT + front(cfg)


@pytest.mark.parametrize("i", range(STEPS))
def test_decode_step_logits_match_reference(pair, i):
    cfg, params, _, _, _, want, _, teacher = pair
    _, got, _ = run_port(cfg, params, teacher)
    np.testing.assert_allclose(got[i].numpy(), want[i], **TOL)


def test_generate_matches_reference_tokens(pair):
    cfg, params, jcfg, jparams, _, _, _, _ = pair
    tokens, embeds = inputs(cfg, seed=2)
    want = jgenerate(jparams, jcfg, jnp.asarray(tokens), max_new_tokens=3,
                     embeds=None if embeds is None else jnp.asarray(embeds))
    got = generate(params, cfg, tokens, max_new_tokens=3, embeds=embeds,
                   device="cpu")
    assert got.dtype == np.int32 and got.shape == (B, 3)
    np.testing.assert_array_equal(got, want)


def test_cache_after_prefill_matches_reference(pair):
    """Every cache buffer after prefill, layer by layer, in the
    reference's layout (stacked over periods there): the same keys,
    shapes and dtypes; a mamba layer's conv and SSM state and a bf16 or
    float32 k/v within 2e-3 of the reference's.  The int8 cache: each
    buffer is the reference's quantizer of the port's own rows, bitwise
    (:func:`test_int8_rows_are_the_reference_quantizer`), and so within
    one step of the reference's buffer -- the rows themselves come out
    of matmuls that sum in another order, a few ulps apart."""
    cfg, params, _, _, _, _, want, teacher = pair
    _, _, got = run_port(cfg, params, teacher)
    for i, period in enumerate(got["periods"]):
        for pos, layer in period.items():
            ref = want["periods"][pos]
            assert set(layer) == set(ref), (pos, sorted(layer))
            for name, buf in layer.items():
                w = ref[name][i]
                assert tuple(buf.shape) == w.shape, (pos, name)
                assert str(buf.dtype)[6:] == str(w.dtype), (pos, name)
                if buf.dtype == torch.int8:
                    diff = np.abs(buf.numpy().astype(np.int32)
                                  - w.astype(np.int32))
                    assert diff.max() <= 1 and diff.mean() < 1e-2, (pos, name)
                else:
                    np.testing.assert_allclose(buf.numpy(), w, rtol=2e-3,
                                               atol=1e-6 if "scale" in name
                                               else 2e-3)


def test_int8_rows_are_the_reference_quantizer():
    """``_quant_rows`` bitwise the reference's jitted one -- XLA's
    product with float32(1/127) fused with the 1e-12 add, then round
    half to even -- on rows over nine decades of scale, with zero rows
    and exact .5 quotients, and on the reference model's own cached
    rows against its int8 cache; and the port's int8 cache after
    prefill is that quantizer of the rows a prefill without it caches,
    bitwise."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 2048, 16))
         * 10.0 ** rng.uniform(-7, 2, (8, 2048, 1))).astype(np.float32)
    x[0, :4] = 0.0
    x[1, :, 0] = 127.0
    x[1, :, 1] = 0.5
    x[1, :, 2] = -1.5
    wq, ws = jax.jit(jmodel._quant_rows)(jnp.asarray(x))
    gq, gs = model._quant_rows(torch.from_numpy(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))

    # the reference's own cached rows: its prefill without the int8
    # cache caches them, with it quantizes them (prefill attends the
    # fresh rows, so both prefills compute the same ones)
    _, jquant = configs("gemma-2b-int8-cache")
    jplain = dataclasses.replace(jquant, kv_quant=False)
    jparams = jmodel.init_params(jplain, jax.random.key(3))
    tokens, _ = inputs(jquant)
    jcaches = {}
    for jcfg in (jplain, jquant):
        c = jmodel.init_cache(jcfg, B, PROMPT)
        _, c = jax.jit(lambda p, t, c, jcfg=jcfg: jmodel.prefill(
            p, jcfg, t, c))(jparams, jnp.asarray(tokens), c)
        jcaches[jcfg.kv_quant] = c["periods"]["0"]
    for name in ("k", "v"):
        gq, gs = model._quant_rows(torch.from_numpy(
            np.array(jcaches[False][name])))
        np.testing.assert_array_equal(gq.numpy(),
                                      np.asarray(jcaches[True][name]))
        np.testing.assert_array_equal(
            gs.numpy().view(np.int32),
            np.asarray(jcaches[True][name + "_scale"]).view(np.int32))

    quant, _ = configs("gemma-2b-int8-cache")
    plain = dataclasses.replace(quant, kv_quant=False)
    params = model.init_params(plain, torch.Generator().manual_seed(0), "cpu")
    tokens, _ = inputs(plain)
    caches = {}
    for cfg in (plain, quant):
        c = model.init_cache(cfg, B, PROMPT + 2, device="cpu")
        model.prefill(params, cfg, torch.from_numpy(tokens), c)
        caches[cfg.kv_quant] = c
    for rows, q in zip(caches[False]["periods"], caches[True]["periods"]):
        for name in ("k", "v"):
            want_q, want_s = model._quant_rows(rows["0"][name][:, :, :PROMPT])
            assert torch.equal(q["0"][name][:, :, :PROMPT], want_q)
            assert torch.equal(q["0"][name + "_scale"][:, :, :PROMPT],
                               want_s)
            assert not q["0"][name][:, :, PROMPT:].any()


def test_vision_prompt_fills_the_front_end_positions():
    """The front end's tokens come first: a prefill with embeds advances
    the cache by n_front + S, and changing the embeds changes the
    logits, while a prefill without them serves the tokens alone."""
    cfg, _ = configs("pixtral-12b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens, embeds = inputs(cfg)
    outs = []
    for e in (embeds, embeds * 2.0, None):
        c = model.init_cache(cfg, B, PROMPT + front(cfg), device="cpu")
        logits, c = model.prefill(params, cfg, torch.from_numpy(tokens), c,
                                  None if e is None else torch.from_numpy(e))
        assert c["pos"] == PROMPT + (0 if e is None else front(cfg))
        outs.append(logits)
    assert not torch.allclose(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])
