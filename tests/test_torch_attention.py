"""The port's flash attention and attention module against the reference.

``flash_attention_plain`` (the kernel's plain version) is held against
the reference's Pallas kernel run in interpret mode on the same
numpy-seeded inputs: MHA, GQA and MQA, Sq == Sk and Sq < Sk (queries
right-aligned), no window and windows 8, 16 and 33, head_dim 16 and 64.
Tolerances: float32 rtol = atol = 1e-5 (the same online softmax, blocks
of another size: sums in another order); bfloat16 rtol = 8e-3, atol =
1e-3 (both compute in float32 and round the output to bfloat16 once,
where a rounding on the other side of a tie is one bf16 ulp, at most
2^-7 of the value; atol for values near 0).

The port's ``attention`` is held against the reference's ``attention``
at rtol = atol = 2e-3, the reference's own bound for its blockwise path
against the Pallas kernel (tests/test_attention_module.py): prefill
(the kernel's plain version against the blockwise scan) and decode rows
(dense rows against dense rows) at an explicit offset.  Its blockwise
backend is held against the reference's at rtol = atol = 1e-5: the same
online softmax over the same blocks, in float32.  Tests marked
``cuda`` hold the CUDA kernel against its plain version on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models.attention import attention as jattention
from repro_torch.kernels import cuda, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import attention

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=8e-3, atol=1e-3)
MODULE = dict(rtol=2e-3, atol=2e-3)


def qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                               (b, hkv, sk, d)))


def to_torch(arrays, dtype=torch.float32, device="cpu"):
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in arrays)


# (b, hq, hkv, sq, sk, d, window): MHA, GQA, MQA; square and Sq < Sk;
# windows 8, 16, 33; d 16 and 64
CASES = [
    (1, 4, 4, 40, 40, 16, None),
    (2, 4, 2, 40, 40, 64, None),
    (1, 4, 1, 24, 70, 16, None),
    (1, 4, 2, 70, 70, 16, 8),
    (2, 4, 1, 40, 40, 64, 16),
    (1, 4, 4, 30, 100, 16, 33),
    (1, 2, 2, 100, 100, 64, 33),
    (1, 4, 2, 17, 17, 16, 16),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_plain_matches_pallas_f32(case):
    b, hq, hkv, sq, sk, d, window = case
    arrays = qkv(sq * 7 + d, b, hq, hkv, sq, sk, d)
    want = jflash(*map(jnp.asarray, arrays), causal=True, window=window,
                  interpret=True)
    got = fa.flash_attention_plain(*to_torch(arrays), True, window)
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]], ids=str)
def test_flash_plain_matches_pallas_bf16(case):
    b, hq, hkv, sq, sk, d, window = case
    arrays = qkv(sq * 11 + d, b, hq, hkv, sq, sk, d)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                  causal=True, window=window, interpret=True)
    got = fa.flash_attention_plain(*to_torch(arrays, torch.bfloat16), True,
                                   window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_flash_plain_without_the_causal_mask():
    arrays = qkv(5, 1, 4, 2, 40, 40, 16)
    want = jflash(*map(jnp.asarray, arrays), causal=False, window=None,
                  interpret=True)
    got = fa.flash_attention_plain(*to_torch(arrays), False, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("sq, sk, window", [
    (64, 64, None), (100, 100, 33), (40, 90, None), (48, 48, 16)])
def test_attention_prefill_matches_reference_blockwise(sq, sk, window):
    arrays = qkv(sq + sk, 2, 4, 2, sq, sk, 64)
    want = jattention(*map(jnp.asarray, arrays), causal=True, window=window,
                      q_chunk=32, block_k=32)
    ops.reset_dispatch_counts()
    got = attention(*to_torch(arrays), causal=True, window=window)
    assert ops.DISPATCH_COUNTS[("flash_attention", "plain")] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)


@pytest.mark.parametrize("sq, sk, offset, window", [
    (1, 64, 39, None), (1, 64, 63, 16), (4, 50, 20, 8), (16, 16, 0, None)])
def test_attention_dense_rows_match_reference(sq, sk, offset, window):
    arrays = qkv(sq * 3 + offset, 1, 4, 1, sq, sk, 16)
    want = jattention(*map(jnp.asarray, arrays), causal=True, window=window,
                      q_offset=offset)
    ops.reset_dispatch_counts()
    got = attention(*to_torch(arrays), causal=True, window=window,
                    q_offset=offset)
    assert not ops.DISPATCH_COUNTS                  # no kernel for decode
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)


# (b, hq, hkv, sq, sk, window, q_offset, q_chunk, block_k): GQA and MQA;
# a window; queries at an offset into longer keys; sk that block_k does
# not divide; several q chunks, each with its own key prefix
BLOCKWISE = [
    (2, 4, 2, 40, 40, None, None, 16, 8),
    (1, 8, 2, 50, 70, 13, None, 16, 16),
    (2, 4, 4, 33, 90, None, 20, 8, 32),
    (1, 4, 1, 100, 100, 20, 0, 32, 24),
    (1, 4, 2, 64, 64, 33, None, 2048, 2048),
]


@pytest.mark.parametrize("case", BLOCKWISE, ids=str)
def test_blockwise_backend_matches_reference(case):
    b, hq, hkv, sq, sk, window, offset, q_chunk, block_k = case
    q, k, v = qkv(sq + sk, b, hq, hkv, sq, sk, 16)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=window, q_offset=offset,
                      q_chunk=q_chunk, block_k=block_k)
    got = attention(*to_torch((q, k, v)), causal=True, window=window,
                    q_offset=offset, backend="blockwise", q_chunk=q_chunk,
                    block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_blockwise_agrees_with_the_kernel_and_refuses_other_backends():
    """Right-aligned, the blockwise backend and the kernel's plain
    version give the same attention (within the float32 bound); an
    unknown backend raises."""
    q, k, v = to_torch(qkv(9, 2, 4, 2, 60, 60, 16))
    ops.reset_dispatch_counts()
    got = attention(q, k, v, window=16, backend="blockwise", block_k=32)
    assert ops.DISPATCH_COUNTS[("flash_attention", "plain")] == 0
    np.testing.assert_allclose(got.numpy(),
                               attention(q, k, v, window=16).numpy(), **F32)
    with pytest.raises(ValueError, match="backend"):
        attention(q, k, v, backend="pallas")


def test_flash_outside_the_gate_raises():
    q = torch.zeros(1, 3, 20, 16)
    k = torch.zeros(1, 2, 20, 16)
    with pytest.raises(ValueError, match="gate"):
        ops.flash_attention(q, k, k)                 # 3 heads over 2
    big = torch.zeros(1, 2, 20, 320)
    with pytest.raises(ValueError, match="gate"):
        ops.flash_attention(big, big, big)           # head_dim > 256
    i = torch.zeros(1, 2, 20, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="gate"):
        ops.flash_attention(i, i, i)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    # the plain version's einsums run as full float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(1, 2, 1, 300, 300, 256, 100),
                                          (1, 2, 2, 65, 65, 48, None)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_the_card(card, case, dtype):
    """The kernel against its plain version on the same card tensors:
    float32 within 1e-5 (another summation order), bfloat16 within rtol
    8e-3, atol 1e-3 (one bf16 ulp where a rounding tips); head_dim 48 goes through the
    zero-padded 64 instantiation."""
    b, hq, hkv, sq, sk, d, window = case
    q, k, v = to_torch(qkv(sq + d, b, hq, hkv, sq, sk, d), dtype, card)
    cuda.reset_launches()
    got = fa.flash_attention(q, k, v, True, window)
    assert cuda.LAUNCHES["flash_attention"] == 1
    want = fa.flash_attention_plain(q, k, v, True, window)
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
