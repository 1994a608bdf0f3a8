"""The port's dense serving path against the reference model.

On the smoke configurations of the five dense architectures (float32),
the reference's ``init_params`` draws the weights and
``models.convert.params_from_reference`` carries them over, so both
models hold the same numbers.  Then, on the same numpy-seeded prompt of
48 tokens (past 16, so the port's prefill goes through the
flash-attention kernel's plain version and the reference's through its
blockwise scan; on gemma3 past its 16-token smoke window):

* the last-position ``prefill`` logits agree;
* each of 4 teacher-forced ``decode_step`` logits agrees (the port's
  dense rows against the reference's, over the whole cache buffer);
* ``generate`` gives the reference's tokens.

Bound: rtol = atol = 2e-3, the reference's own tolerance for its
blockwise attention against its Pallas kernel
(tests/test_attention_module.py): the two attention paths sum in
another order, in float32.  Tests marked ``cuda`` run the same on the
card against the CPU.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke_config
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import model as jmodel
from repro.serve.engine import generate as jgenerate
from repro_torch.configs import ARCHS, SSMConfig, smoke_config
from repro_torch.kernels import cuda, ops
from repro_torch.models import model
from repro_torch.models.convert import params_from_reference, tree_map
from repro_torch.serve import generate

# musicgen-medium's audio front end is a stub in the reference, which
# serves it as a dense decoder over audio codes (ROADMAP C11)
DENSE = ["gemma3-12b", "gemma-2b", "llama3-405b", "mistral-large-123b",
         "musicgen-medium"]
B, PROMPT, STEPS = 2, 48, 4
TOL = dict(rtol=2e-3, atol=2e-3)


def prompt_tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(port cfg, port params on the CPU, reference cfg, reference params,
    the reference's prefill and decode logits, the teacher tokens)."""
    jcfg = jsmoke_config(JARCHS[request.param])
    cfg = smoke_config(ARCHS[request.param])
    jparams = jmodel.init_params(jcfg, jax.random.key(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_reference(tree, cfg, "cpu")
    tokens = prompt_tokens(cfg)
    teacher = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    cache = jmodel.init_cache(jcfg, B, PROMPT + STEPS)
    logits, cache = jax.jit(lambda p, t, c: jmodel.prefill(p, jcfg, t, c))(
        jparams, jnp.asarray(tokens), cache)
    step = jax.jit(lambda p, t, c: jmodel.decode_step(p, jcfg, t, c))
    steps = []
    for i in range(STEPS):
        out, cache = step(jparams, jnp.asarray(teacher[:, i:i + 1]), cache)
        steps.append(np.asarray(out))
    return cfg, params, jcfg, jparams, np.asarray(logits), steps, teacher


def run_port(cfg, params, tokens, teacher, device):
    cache = model.init_cache(cfg, B, PROMPT + STEPS, device=device)
    logits, cache = model.prefill(params, cfg,
                                  torch.from_numpy(tokens).to(device), cache)
    steps = []
    for i in range(STEPS):
        out, cache = model.decode_step(
            params, cfg, torch.from_numpy(teacher[:, i:i + 1]).to(device),
            cache)
        steps.append(out)
    return logits, steps


def test_prefill_logits_match_reference(pair):
    cfg, params, _, _, want, _, teacher = pair
    ops.reset_dispatch_counts()
    got, _ = run_port(cfg, params, prompt_tokens(cfg), teacher, "cpu")
    assert got.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the prefill went through the kernel's plain version, once a layer
    assert ops.DISPATCH_COUNTS[("flash_attention", "plain")] == cfg.n_layers


@pytest.mark.parametrize("i", range(STEPS))
def test_decode_step_logits_match_reference(pair, i):
    cfg, params, _, _, _, want, teacher = pair
    _, got = run_port(cfg, params, prompt_tokens(cfg), teacher, "cpu")
    np.testing.assert_allclose(got[i].numpy(), want[i], **TOL)


def test_generate_matches_reference_tokens(pair):
    cfg, params, jcfg, jparams, _, _, _ = pair
    tokens = prompt_tokens(cfg, seed=2)
    want = jgenerate(jparams, jcfg, jnp.asarray(tokens), max_new_tokens=3)
    got = generate(params, cfg, tokens, max_new_tokens=3, device="cpu")
    assert got.dtype == np.int32 and got.shape == (B, 3)
    np.testing.assert_array_equal(got, want)


def test_params_carry_over_unstacks_the_periods():
    jcfg = jsmoke_config(JARCHS["gemma3-12b"])
    cfg = smoke_config(ARCHS["gemma3-12b"])
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.key(0)))
    params = params_from_reference(tree, cfg, device="cpu")
    assert len(params["periods"]) == cfg.n_periods == 2
    assert "unembed" not in params               # tied embeddings
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    for i in range(cfg.n_periods):
        for pos in range(cfg.period):
            np.testing.assert_array_equal(
                params["periods"][i][str(pos)]["mlp"]["w_up"].numpy(),
                tree["periods"][str(pos)]["mlp"]["w_up"][i])
    llama = smoke_config(ARCHS["llama3-405b"])
    jllama = jsmoke_config(JARCHS["llama3-405b"])
    p = params_from_reference(jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jllama, jax.random.key(0))), llama,
        device="cpu")
    assert p["unembed"].shape == (llama.d_model, llama.padded_vocab)


SMOKE_SSM = SSMConfig(d_state=16, head_dim=16, chunk=32)


# The layers and options of ROADMAP A12's serving half, which the port
# once refused; the test keeps its name from then.  A mamba position
# needs an SSM config: the smoke one rides along with the pattern.
@pytest.mark.parametrize("change", [
    {"ssm": SSMConfig()},
    {"frontend": "vision", "n_frontend_tokens": 8},
    {"kv_quant": True},
    {"attn_positions": (0,), "period": 2, "ssm": SMOKE_SSM},
])
def test_unported_layers_raise_naming_their_roadmap_item(change):
    """llama3-405b's smoke config with one of A12's changes: an SSM
    config beside attention-only layers, the vision front end, the int8
    KV cache, and a period of one attention and one mamba layer.
    ``init_params`` builds it, and ``generate`` on the CPU gives the
    reference's tokens (the reference's weights carried over)."""
    cfg = dataclasses.replace(smoke_config(ARCHS["llama3-405b"]), **change)
    jcfg = dataclasses.replace(jsmoke_config(JARCHS["llama3-405b"]), **{
        k: (JSSMConfig(**dataclasses.asdict(v)) if k == "ssm" else v)
        for k, v in change.items()})
    own = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ("frontend_proj" in own) == (cfg.frontend == "vision")
    jparams = jmodel.init_params(jcfg, jax.random.key(4))
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    embeds = (rng.standard_normal((B, 8, cfg.frontend_dim)).astype(np.float32)
              if cfg.frontend == "vision" else None)
    want = jgenerate(jparams, jcfg, jnp.asarray(tokens), max_new_tokens=3,
                     embeds=None if embeds is None else jnp.asarray(embeds))
    got = generate(params, cfg, tokens, 3, embeds=embeds, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_prefill_with_a_misaligned_offset_raises():
    from repro_torch.models.attention import attention
    q = torch.zeros(1, 2, 20, 16)
    k = torch.zeros(1, 2, 30, 16)
    with pytest.raises(ValueError, match="right-aligns"):
        attention(q, k, k, q_offset=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_gemma3_smoke_on_the_card_matches_the_cpu(card):
    """Same weights, prompt and teacher tokens on the card (the flash
    kernel, cuBLAS in full float32) and on the CPU (plain versions):
    logits within 2e-3 and the same generated tokens."""
    cfg = smoke_config(ARCHS["gemma3-12b"])
    params = model.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    on_card = tree_map(lambda w: w.to(card), params)
    tokens = prompt_tokens(cfg)
    teacher = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    cuda.reset_launches()
    got, got_steps = run_port(cfg, on_card, tokens, teacher, card)
    assert cuda.LAUNCHES["flash_attention"] == cfg.n_layers
    want, want_steps = run_port(cfg, params, tokens, teacher, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    for a, b in zip(got_steps, want_steps):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **TOL)
    np.testing.assert_array_equal(
        generate(on_card, cfg, tokens, 4), generate(params, cfg, tokens, 4,
                                                    device="cpu"))
