"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), on the CPU in float32.

The same numpy-seeded inputs go through both: ``ssd_chunked`` with
chunks that divide the length and chunks that do not (the pad path),
with and without an initial state; ``_causal_conv`` with and without a
state; ``mamba_block`` over a prompt, then decode steps from the state
it left, with the reference's ``init_mamba`` weights carried over.

Bound: rtol = atol = 1e-5.  Both compute in float32; the reference's
three-operand einsums and the port's pairwise products sum in other
orders (the reference's jitted cumsum too), a few float32 ulps of the
O(1-10) outputs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as jssm
from repro_torch.configs.base import SSMConfig
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def scan_inputs(seed, b, s, h, p, n, with_state):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return (f(b, s, h, p), rng.uniform(1e-3, 0.2, (b, s, h)).astype(
        np.float32), -rng.uniform(1.0, 16.0, h).astype(np.float32),
        f(b, s, n), f(b, s, n), f(h), f(b, h, p, n) if with_state else None)


# (b, s, h, p, n, chunk): chunks that divide s, and 50 / 32, 7 / 4 and
# 100 / 64 that do not (the pad rows)
SHAPES = [(2, 64, 4, 16, 16, 32), (2, 50, 4, 16, 16, 32),
          (1, 7, 2, 8, 4, 4), (1, 100, 3, 5, 6, 64), (2, 32, 2, 16, 16, 32)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ssd_chunked_matches_reference(shape, with_state):
    b, s, h, p, n, chunk = shape
    x, dt, a, bi, ci, d, st = scan_inputs(sum(shape), b, s, h, p, n,
                                          with_state)
    wy, wst = jax.jit(lambda *z: jssm.ssd_chunked(*z[:6], chunk, z[6]))(
        x, dt, a, bi, ci, d, st)
    gy, gst = ssm.ssd_chunked(t(x), t(dt), t(a), t(bi), t(ci), t(d), chunk,
                              t(st))
    assert gy.shape == (b, s, h, p) and gy.dtype == torch.float32
    assert gst.shape == (b, h, p, n) and gst.dtype == torch.float32
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), **TOL)


def test_ssd_chunked_pad_rows_leave_the_final_state():
    """The state after 50 rows padded to 64 is the state after the 50
    real rows: chunked at 25 (no pad) gives it too."""
    x, dt, a, bi, ci, d, _ = scan_inputs(3, 2, 50, 4, 8, 8, False)
    args = tuple(t(z) for z in (x, dt, a, bi, ci, d))
    y32, st32 = ssm.ssd_chunked(*args, 32)
    y25, st25 = ssm.ssd_chunked(*args, 25)
    np.testing.assert_allclose(st32.numpy(), st25.numpy(), **TOL)
    np.testing.assert_allclose(y32.numpy(), y25.numpy(), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("seq", [1, 9])
def test_causal_conv_matches_reference(seq, with_state):
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = (rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state
          else None)
    wy, wst = jax.jit(lambda *z: jssm._causal_conv(*z))(x, w, b, st)
    gy, gst = ssm._causal_conv(t(x), t(w), t(b), t(st))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


def _carry(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("prompt", [64, 45])
def test_mamba_block_prefill_then_decode_matches_reference(prompt):
    """A prompt (45 tokens: a chunk of 32 that does not divide it), then
    four decode steps from the state it left, each step's output and
    state against the reference's."""
    d = 64
    js = JSSMConfig(d_state=16, head_dim=16, chunk=32)
    s = SSMConfig(d_state=16, head_dim=16, chunk=32)
    jparams = jssm.init_mamba(jax.random.key(prompt), d, js, jnp.float32)
    params = _carry(jparams)
    x = np.random.default_rng(prompt).standard_normal(
        (2, prompt + 4, d)).astype(np.float32)
    block = jax.jit(lambda p, z, st: jssm.mamba_block(p, z, js, st))
    wst = jssm.init_mamba_state(2, d, js, jnp.float32)
    gst = ssm.init_mamba_state(2, d, s, torch.float32)
    wy, wst = block(jparams, x[:, :prompt], wst)
    gy, gst = ssm.mamba_block(params, t(x[:, :prompt]), s, gst)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    for i in range(prompt, prompt + 4):
        wy, wst = block(jparams, x[:, i:i + 1], wst)
        gy, gst = ssm.mamba_decode_step(params, t(x[:, i:i + 1]), s, gst)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(gst.ssm.numpy(), np.asarray(wst.ssm),
                                   **TOL)
        np.testing.assert_allclose(gst.conv.numpy(), np.asarray(wst.conv),
                                   **TOL)
    # without a state the block runs the scan from zeros, as the
    # reference's train path does
    wy, _ = jax.jit(lambda p, z: jssm.mamba_block(p, z, js))(jparams, x)
    gy, _ = ssm.mamba_block(params, t(x), s)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)


def test_init_mamba_has_the_reference_shapes_and_dtypes():
    d = 64
    js = JSSMConfig(d_state=16, head_dim=16, chunk=32)
    s = SSMConfig(d_state=16, head_dim=16, chunk=32)
    want = jssm.init_mamba(jax.random.key(0), d, js, jnp.bfloat16)
    got = ssm.init_mamba(torch.Generator().manual_seed(0), d, s,
                         torch.bfloat16, "cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype)[6:] == str(w.dtype), name
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["dt_bias"].numpy(),
                                  np.asarray(want["dt_bias"]))
