"""The port's training path against the reference's.

On float32 smoke configurations the reference's ``init_params`` draws
the weights and ``models.convert.params_from_reference`` carries them
over; both packages get the same numpy-seeded batches.  Then:

* ``train_loss`` and every gradient leaf against
  ``jax.value_and_grad(repro.models.model.train_loss)`` on gemma-2b,
  granite-moe-3b-a800m, mamba2-130m and pixtral-12b (with ``embeds``);
* ``remat="none"`` and ``"dots"`` give ``"full"``'s loss and gradients;
* ``chunked_cross_entropy`` on a padded vocab with ignored labels, and
  its gradients;
* the flash-attention ``autograd.Function`` (the kernel's plain
  version forward, the blockwise scan's gradient backward) against the
  reference's blockwise ``jax.grad``, with a window and with GQA;
* ``adamw_update`` (the clip, bf16 moments) and ``cosine_schedule``;
* ten ``train`` steps from converted weights on the reference's own
  ``TokenPipeline`` batches against the reference's loop.

Bounds: the loss and gradients within rtol 1e-4 + atol 1e-6 (float32
sums in other orders: measured ~2e-6 of the largest element); the ten
steps' losses within rtol 1e-4 (AdamW's normalized steps carry the
gradients' rounding into the weights: measured 1.8e-5 on mamba2 after
ten steps); the optimizer within rtol 2e-6 (float32 ``pow`` of the bias
corrections may round apart by an ulp); the flash gradients within
rtol 1e-5 + atol 1e-6.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch.train import train as jtrain
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models import attention, layers, model, ssm
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference, tree_leaves)
from repro_torch.optim import adamw

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: its eager ops are tiny,
    and the suite runs several worker processes at once, whose extra
    threads would only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRAIN_ARCHS = ["gemma-2b", "granite-moe-3b-a800m", "mamba2-130m",
               "pixtral-12b"]
B, S = 2, 40
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def make_batch(cfg, seed=0) -> dict:
    """Numpy batch: (B, S) tokens and next-token labels, the first three
    labels of row 0 ignored; vision embeds where the config has them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_loss_and_grads(params, cfg, batch, remat="full"):
    ls = tree_leaves(params)
    for p in ls:
        p.requires_grad_(True)
    loss = model.train_loss(params, cfg, as_torch(batch), remat=remat)
    return loss.detach(), torch.autograd.grad(loss, ls)


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def pair(request):
    """(port cfg, port params, reference cfg, reference params, batch)."""
    jcfg = jsmoke_config(JARCHS[request.param])
    cfg = smoke_config(ARCHS[request.param])
    jparams = jmodel.init_params(jcfg, jax.random.key(1))
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return cfg, params, jcfg, jparams, make_batch(cfg)


def test_loss_and_every_gradient_match_reference(pair):
    cfg, params, jcfg, jparams, batch = pair
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, jcfg, b, remat="full")))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = tree_leaves(params_from_reference(
        jax.tree_util.tree_map(np.asarray, jgrads), cfg, "cpu"))
    loss, grads = port_loss_and_grads(params, cfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-1.5-large-398b",
                                  "gemma3-12b"])
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_modes_agree(arch, remat):
    """Checkpointing changes what is kept, not what is computed: each
    mode's loss and gradients equal ``"full"``'s bitwise on the CPU."""
    cfg = smoke_config(ARCHS[arch])
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, seed=2)
    loss_full, grads_full = port_loss_and_grads(params, cfg, batch, "full")
    loss, grads = port_loss_and_grads(params, cfg, batch, remat)
    assert torch.equal(loss, loss_full)
    for a, b in zip(grads, grads_full):
        assert torch.equal(a, b)


def test_unknown_remat_raises():
    cfg = smoke_config(ARCHS["gemma-2b"])
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat"):
        model.train_loss(params, cfg, as_torch(make_batch(cfg)),
                         remat="offload")


@pytest.mark.parametrize("chunk", [7, 16, 512])
def test_chunked_cross_entropy_matches_reference(chunk):
    """vocab 50 padded to 64 (rows 50.. masked), a chunk that does not
    divide the 24 positions, ignored labels; the loss and its gradients
    with respect to the hidden states and the unembedding."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((16, 64)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    labels[1, ::5] = -1
    fn = lambda x_, w_: jlayers.chunked_cross_entropy(  # noqa: E731
        x_, w_, jnp.asarray(labels), chunk=chunk, vocab_size=50)
    jl, (jgx, jgw) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = layers.chunked_cross_entropy(xt, wt, torch.from_numpy(labels),
                                        chunk=chunk, vocab_size=50)
    gx, gw = torch.autograd.grad(loss, (xt, wt))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **GRAD_TOL)
    with torch.no_grad():
        assert torch.equal(layers.chunked_cross_entropy(
            xt, wt, torch.from_numpy(labels), chunk=chunk, vocab_size=50),
            loss.detach())


@pytest.mark.parametrize("hq,hkv,window", [(4, 2, 8), (4, 1, None),
                                           (2, 2, 20)])
def test_flash_function_gradients_match_reference_blockwise(hq, hkv, window):
    """dq, dk, dv of ``attention`` under autograd (FlashAttentionFn:
    the kernel's plain version forward, the blockwise recompute
    backward) against ``jax.grad`` of the reference's blockwise
    attention at the same chunking; GQA, MQA and two windows."""
    rng = np.random.default_rng(4)
    sq, d = 40, 16
    q = rng.standard_normal((2, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, sq, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, sq, d)).astype(np.float32)
    dout = rng.standard_normal((2, hq, sq, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=16, block_k=8)

    def jloss(q_, k_, v_):
        o = jattention.attention(q_, k_, v_, backend="blockwise", **kw)
        return jnp.sum(o * dout)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention.attention(*qkv, **kw)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(
        out.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(out.detach(), ops.flash_attention(
            *qkv, causal=True, window=window))
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(dout))
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_attention_without_gradients_stays_the_serving_path():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 24, 16)).astype(
        np.float32)) for _ in range(3))
    out = attention.attention(q, k, v, window=8)
    assert out.grad_fn is None
    assert torch.equal(out, ops.flash_attention(q, k, v, window=8))
    with torch.no_grad():
        out = attention.attention(q.requires_grad_(True), k, v, window=8)
    assert out.grad_fn is None


def _opt_trees(rng):
    shapes = {"w": (8, 16), "b": (16,), "blk": {"u": (4, 4, 3),
                                                "s": (4,)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * 3).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple)) for _ in range(3)]
    return params, grads


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_reference(moment_dtype, clip):
    """Three steps (the first two clipped where clip=1.0: the gradients'
    norm is ~30) at a scheduled learning rate, bf16 parameters under
    bf16 moments; params, moments, step and the gradient norm."""
    rng = np.random.default_rng(6)
    params, grads = _opt_trees(rng)
    pdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    jcfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip, moment_dtype=pdt)
    cfg = adamw.AdamWConfig(lr=1e-2, clip_norm=clip, moment_dtype=tdt)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, pdt), params)
    p = _to_torch(params, tdt)
    jstate = jadamw.adamw_init(jp, jcfg)
    state = adamw.adamw_init(p, cfg)
    for g in grads:
        lr_j = jadamw.cosine_schedule(jstate["step"], 1e-2, 1, 3)
        lr = adamw.cosine_schedule(state["step"], 1e-2, 1, 3)
        np.testing.assert_allclose(float(lr), float(lr_j), rtol=2e-6)
        jp, jstate, jnorm = jadamw.adamw_update(
            jp, jax.tree_util.tree_map(lambda a: jnp.asarray(a, pdt), g),
            jstate, jcfg, lr=lr_j)
        p, state, norm = adamw.adamw_update(p, _to_torch(g, tdt), state,
                                            cfg, lr=lr)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=2e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    tol = dict(rtol=2e-6, atol=1e-7) if tdt == torch.float32 else dict(
        rtol=8e-3, atol=1e-6)
    for name, got, want in (("params", p, jp), ("m", state["m"], jstate["m"]),
                            ("v", state["v"], jstate["v"])):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == tdt, name
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b).astype(np.float32),
                                       err_msg=name, **tol)


def test_adamw_update_is_in_place_and_decays_matrices_only():
    params = {"w": torch.ones((3, 3)), "b": torch.ones((3,))}
    ids = {k: v.data_ptr() for k, v in params.items()}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=None)
    state = adamw.adamw_init(params, cfg)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    params, state, _ = adamw.adamw_update(params, zero, state, cfg)
    assert {k: v.data_ptr() for k, v in params.items()} == ids
    # zero gradient: only the decay moves the matrix, by lr * wd * p
    assert torch.allclose(params["w"], torch.full((3, 3), 0.95))
    assert torch.equal(params["b"], torch.ones((3,)))


def test_cosine_schedule_matches_reference():
    for step in (0, 1, 5, 19, 20, 21, 50, 99, 100, 150):
        got = adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    3e-4, 20, 100)
        want = jadamw.cosine_schedule(jnp.asarray(step, jnp.int32), 3e-4,
                                      20, 100)
        np.testing.assert_allclose(float(got), float(want), rtol=2e-7)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_ten_train_steps_match_reference_loop(arch):
    """``train`` from the reference's initial weights on its own batches
    (its ``TokenPipeline``, injected) gives its loop's losses."""
    jcfg = dataclasses.replace(jsmoke_config(JARCHS[arch]), vocab_size=512,
                               d_model=64)
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), vocab_size=512,
                              d_model=64)
    kw = dict(batch=4, seq=32, lr=3e-3, warmup=3, log_every=1000)
    want = jtrain(jcfg, 10, **kw)
    params = params_from_reference(jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.key(0))), cfg, "cpu")
    got = train(cfg, 10, device="cpu", params=params,
                pipeline=JTokenPipeline(512, 4, 32, seed=0), **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_opt_state_from_reference_unstacks_the_moments():
    jcfg = jsmoke_config(JARCHS["jamba-1.5-large-398b"])
    cfg = smoke_config(ARCHS["jamba-1.5-large-398b"])
    jparams = jmodel.init_params(jcfg, jax.random.key(2))
    jstate = jadamw.adamw_init(jparams)
    jstate = {"step": jnp.asarray(7, jnp.int32),
              "m": jax.tree_util.tree_map(lambda a: a + 1.0, jstate["m"]),
              "v": jax.tree_util.tree_map(lambda a: a + 2.0, jstate["v"])}
    state = opt_state_from_reference(
        jax.tree_util.tree_map(np.asarray, jstate), cfg, device="cpu")
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    for name, fill in (("m", 1.0), ("v", 2.0)):
        got = tree_leaves(state[name])
        assert [g.shape for g in got] == [p.shape for p in tree_leaves(params)]
        assert all(g.dtype == torch.float32 and bool((g == fill).all())
                   for g in got)


@pytest.mark.parametrize("rate", [1.0, 40.0])
def test_ssd_gradient_is_finite_where_the_reference_overflows(rate):
    """ROADMAP C19: above the diagonal of a chunk, li - lj grows with the
    decay; at rate 40 (dt * A of ~40 a step, as a full-width bf16 run
    reaches) exp overflows and the reference's where(mask, exp, 0) has
    the gradient 0 * inf = NaN.  The port masks the exponent first: the
    same values (rtol 1e-5, as tests/test_torch_ssm.py), gradients equal
    to the reference's where those are finite (rate 1; rtol 1e-3 + atol
    1e-5: the dt gradient sums a chunk's 32 x 32 decayed products, over
    six decades, in other orders) and finite where they are not (rate
    40)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 32, 2, 4)).astype(np.float32)
    dt = (rng.random((1, 32, 2)) + 0.5).astype(np.float32)
    a = np.array([-rate, -rate / 2], np.float32)
    b, c = (rng.standard_normal((1, 32, 8)).astype(np.float32)
            for _ in range(2))
    d = np.ones(2, np.float32)
    w = rng.standard_normal((1, 32, 2, 4)).astype(np.float32)

    def jloss(x_, dt_, b_, c_):
        y, _ = jssm.ssd_chunked(x_, dt_, jnp.asarray(a), b_, c_,
                                jnp.asarray(d), 32)
        return jnp.sum(y * w), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        *map(jnp.asarray, (x, dt, b, c)))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, b, c)]
    y, _ = ssm.ssd_chunked(ts[0], ts[1], torch.from_numpy(a), ts[2], ts[3],
                           torch.from_numpy(d), 32)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    ref_finite = all(np.isfinite(np.asarray(g)).all() for g in jg)
    assert ref_finite == (rate == 1.0)
    if ref_finite:
        for got, want in zip(grads, jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-3, atol=1e-5)
