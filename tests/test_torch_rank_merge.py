"""The rank merge at the landed rows' own width, against the reference.

The port's ``ops._rank_merge`` ranks the (batch, t, c) rows unpadded,
ids ``row * c + col``, and takes the merged keys and the order from
``fused.rank_merge`` (the merge kernel's last level on the card, the
plain ranks and a scatter here).  The reference pads every row to
(pow2 t, pow2 c) with the sort sentinel and unique pad ids, ranks the
padded rows and scatters them.  The pads rank above every real pair, so
the two agree bitwise on the real part; these tests hold them to it:

* ``ops._rank_merge`` against the reference's ``jops._rank_merge`` (its
  Pallas rank kernel in interpret mode), merged keys and order, for
  batch > 1, t and c not powers of two, float32 with duplicates, +-0,
  denormals and +-inf, int32, and bf16 (bits compared as int16);
* ``fused.merge_ranks_plain`` at unpadded c against the reference's
  padded ranks restricted to the real slots;
* ``fused.rank_merge_plain`` against the padded scatter it replaces
  (the port's own earlier dispatch) and against numpy's stable argsort.

A test marked ``cuda`` holds the kernel against the plain versions on
the card and skips where there is none.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bitonic as jbitonic
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro_torch.kernels import bitonic, cuda, fused, ops

EDGES = np.float32([0.0, -0.0, 1e-40, -2e-39, 5e-41, np.inf, -np.inf,
                    1.5, -1.5, 3.75])


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def fold(x: np.ndarray) -> np.ndarray:
    """float32 keys as the comparator sees them: denormals to +-0."""
    x = np.array(x, dtype=np.float32)
    u = x.view(np.uint32)
    u[(u & 0x7F800000) == 0] &= np.uint32(0x80000000)
    return x


def landed_rows(rng, batch, t, c, dtype):
    """(batch, t, c) rows sorted in the comparator's order, as numpy
    (bf16 as its float32 values) and as the torch operand."""
    if dtype == "int32":
        x = np.sort(rng.integers(-4, 4, (batch, t, c)).astype(np.int32),
                    axis=-1)
        x[..., -max(1, c // 5):] = np.iinfo(np.int32).max   # sentinel ties
        return x, torch.from_numpy(x)
    x = rng.normal(size=(batch, t, c)).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.integers(0, flat.size, flat.size // 2)
    flat[pick] = rng.choice(EDGES, pick.size)
    x[..., -max(1, c // 5):] = np.inf                       # PAD tails
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    order = np.argsort(fold(x), axis=-1, kind="stable")
    x = np.take_along_axis(x, order, axis=-1)
    xt = torch.from_numpy(x)
    return x, (xt.to(torch.bfloat16) if dtype == "bfloat16" else xt)


def as_jax(xt: torch.Tensor):
    if xt.dtype == torch.bfloat16:
        return jnp.asarray(xt.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(xt.numpy())


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("batch,t,c", [(2, 3, 5), (3, 6, 40), (2, 5, 33),
                                       (1, 7, 17), (2, 2, 70)])
def test_rank_merge_matches_reference(rng, dtype, batch, t, c):
    _, xt = landed_rows(rng, batch, t, c, dtype)
    merged, order = ops._rank_merge(xt, with_order=True)
    assert merged.shape == order.shape == (batch, t * c)
    assert merged.dtype == xt.dtype and order.dtype == torch.int32
    for b in range(batch):
        wm, wo = jops._rank_merge(as_jax(xt[b]))
        assert_bitwise(merged[b], wm)
        assert_bitwise(order[b], wo)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("t,c", [(3, 5), (6, 40), (5, 33)])
def test_merge_ranks_plain_unpadded_equals_padded_reference(rng, dtype, t, c):
    """The real pairs' ranks do not depend on the pads: the port's plain
    ranks of the unpadded rows are the reference's padded ranks on the
    real slots."""
    _, xt = landed_rows(rng, 1, t, c, dtype)
    ids = torch.arange(t * c, dtype=torch.int32).reshape(1, t, c)
    got = fused.merge_ranks_plain(xt, ids)
    kp = jbitonic._pad_sorted_rows(as_jax(xt[0]),
                                   jbitonic.sort_sentinel(as_jax(xt).dtype))
    tp2, cp2 = kp.shape
    ip = jbitonic._pad_iota_unique(t, c, tp2, cp2)
    want = np.asarray(jfused.merge_ranks(kp, ip))[:t, :c]
    assert_bitwise(got[0], want)
    np.testing.assert_array_equal(np.sort(bits(got).reshape(-1)),
                                  np.arange(t * c))


def padded_scatter(xt: torch.Tensor, bound_block):
    """The scatter the unpadded merge replaces: rows padded to (pow2 t,
    pow2 c) with the sentinel and unique pad ids, ranked, the keys and
    ids scattered, the real prefix kept."""
    batch, t, c = xt.shape
    kp = bitonic._pad_sorted_rows(xt, bitonic.sort_sentinel(xt.dtype))
    tp2, cp2 = kp.shape[-2:]
    ip = bitonic._pad_iota_unique(t, c, tp2, cp2).expand(batch, tp2, cp2)
    pos = fused.merge_ranks_plain(kp, ip.contiguous(), bound_block)
    pos = pos.reshape(batch, -1).long()
    merged = torch.empty((batch, tp2 * cp2), dtype=xt.dtype)
    bitonic.as_bits(merged).scatter_(1, pos,
                                     bitonic.as_bits(kp.reshape(batch, -1)))
    order = torch.empty((batch, tp2 * cp2), dtype=torch.int32)
    order.scatter_(1, pos, ip.reshape(batch, -1))
    return merged[:, :t * c], order[:, :t * c]


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("bound_block", [None, 8])
def test_rank_merge_plain_equals_the_padded_scatter(rng, dtype, bound_block):
    x, xt = landed_rows(rng, 3, 6, 37, dtype)
    got = fused.rank_merge_plain(xt)
    want = padded_scatter(xt, bound_block)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    # and the order is the stable argsort of the flattened rows
    keys = x.reshape(3, -1)
    stable = np.argsort(fold(keys) if dtype != "int32" else keys, axis=-1,
                        kind="stable")
    np.testing.assert_array_equal(got[1].numpy(), stable)


def test_rank_merge_one_row_and_one_column(rng):
    """t = 1 (nothing to merge) and c = 1 (every row one pair)."""
    _, xt = landed_rows(rng, 2, 1, 9, "float32")
    merged, order = fused.rank_merge_plain(xt)
    assert_bitwise(merged, xt.reshape(2, -1))
    np.testing.assert_array_equal(order.numpy(), np.tile(np.arange(9), (2, 1)))
    _, xt = landed_rows(rng, 2, 7, 1, "float32")
    merged, order = ops._rank_merge(xt, with_order=True)
    for b in range(2):
        wm, wo = jops._rank_merge(as_jax(xt[b]))
        assert_bitwise(merged[b], wm)
        assert_bitwise(order[b], wo)


def test_rank_merge_takes_a_strided_operand(rng):
    """The dispatch makes the rows contiguous before the merge."""
    _, xt = landed_rows(rng, 2, 4, 30, "float32")
    wide = torch.cat([xt, xt], dim=-1)[..., :30]
    assert not wide.is_contiguous()
    got = ops._rank_merge(wide, with_order=True)
    want = ops._rank_merge(xt.contiguous(), with_order=True)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_cuda_rank_merge_equals_plain(card, rng, dtype):
    """The kernel, one launch a call, against the plain versions: merged
    keys and order (t = 48, C = 2152: phase A and three device levels),
    and the ranks with ids (t = 6)."""
    _, xt = landed_rows(rng, 2, 48, 2152, dtype)
    cuda.reset_launches()
    got = fused.rank_merge(xt.to(card))
    assert cuda.LAUNCHES["merge_ranks"] == 1
    want = fused.rank_merge_plain(xt)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    _, xs = landed_rows(rng, 3, 6, 300, dtype)
    ids = torch.arange(6 * 300, dtype=torch.int32).reshape(1, 6, 300)
    ids = ids.expand(3, 6, 300).contiguous()
    assert_bitwise(fused.merge_ranks(xs.to(card), ids.to(card), 64),
                   fused.merge_ranks_plain(xs, ids, 64))
