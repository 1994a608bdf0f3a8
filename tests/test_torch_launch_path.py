"""The two ops whose card call is one C call on the operands as the path
holds them: the search with one query row shared by every key row (and
the ``valid_len`` clamp), and the in-tile merges of ragged landed rows.

On the CPU each runs its plain version, held bitwise against the JAX
reference on the same seeded numpy inputs: ``ops.searchsorted`` with a
(q,) row against ``repro.kernels.ops.searchsorted`` row by row (its
Pallas kernel in interpret mode where NaN queries are in play: the
port follows the kernel, which puts them in bucket 0, ROADMAP C8), and
the merges at non-power-of-two t and c with NaN, +-0 and denormal keys
against ``repro.kernels.bitonic``.  The helper that builds the padded
entry slot by slot, as the merge kernel loads it, is held against the
reference's padding.  Tests marked ``cuda`` hold the kernels against
their plain versions on the card, count one launch a call, and skip
where there is no card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bitonic as jbitonic
from repro.kernels import ops as jops
from repro_torch.kernels import bitonic, bucketize, cuda, ops


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


def to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    """float32 numpy -> a torch tensor of ``dtype`` (bf16 rounded as jnp
    rounds it, so both sides hold the same bits)."""
    if dtype == "bfloat16":
        xj = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        return torch.from_numpy(xj.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(x.astype(dtype))


def to_torch_bits(a, dtype: torch.dtype) -> torch.Tensor:
    """A jax array back as a torch tensor of ``dtype``, bit for bit."""
    return torch.from_numpy(bits(a).copy()).view(dtype)


def to_jax(x: torch.Tensor):
    return jnp.asarray(bits(x)).view(jnp.bfloat16) if \
        x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())


def edge_keys(rng, shape, dtype, nan=False) -> np.ndarray:
    """Keys with duplicates, +-inf, +-0 and denormals (and NaN)."""
    if dtype == "int32":
        x = rng.integers(-6, 6, shape).astype(np.int32)
        x.reshape(-1)[::7] = np.iinfo(np.int32).max
        return x
    x = rng.choice(np.float32([-2.5, -1.0, 0.0, 0.5, 3.0]), size=shape)
    flat = x.reshape(-1)
    special = np.float32([np.inf, -np.inf, -0.0, 0.0, 1e-40, -1e-40,
                          3e-39] + ([np.nan] if nan else []))
    flat[::3] = special[rng.integers(0, len(special), flat[::3].size)]
    return x


def sorted_rows(rng, shape, dtype, nan=False) -> torch.Tensor:
    """Rows sorted as the port's sorts leave them: by the plain bitonic
    network (NaN keys where its comparisons put them)."""
    x = to_torch(edge_keys(rng, shape, dtype, nan), dtype)
    return bitonic.bitonic_sort(x.reshape(-1, shape[-1])).reshape(shape)


# ---------------------------------------------------------------------------
# ops.searchsorted with one shared query row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("valid_len", [None, 100])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_ops_searchsorted_shared_row_matches_reference(rng, dtype, batch,
                                                       side, valid_len):
    """A (q,) query row searched in every row of (batch, n) rows, with and
    without ``valid_len``, equals the reference's ``ops.searchsorted``
    of each row.  bf16 rows take float32 queries (SMMS's boundaries,
    C10), which the reference searches by jnp."""
    n = 130
    rows = sorted_rows(rng, (batch, n), dtype)
    q = edge_keys(rng, (63,), dtype)
    if dtype != "bfloat16":
        q[:5] = rows[0, ::29].numpy()          # keys of the rows
    queries = torch.from_numpy(q)           # float32 over bf16 rows
    got = ops.searchsorted(rows, queries, side=side, valid_len=valid_len)
    assert got.shape == (batch, 63) and got.dtype == torch.int32
    backend = "reference" if dtype == "bfloat16" else "pallas"
    for r in range(batch):
        want = jops.searchsorted(to_jax(rows[r]), jnp.asarray(q), side=side,
                                 backend=backend, valid_len=valid_len)
        assert_bitwise(got[r], want)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_searchsorted_nan_queries_land_first(rng, dtype, side):
    """NaN queries (and NaN keys wherever the bitonic sort leaves them)
    through a shared row: bucket 0, as the reference's Pallas kernel
    puts them (C8)."""
    rows = sorted_rows(rng, (4, 77), dtype, nan=True)
    q = edge_keys(rng, (20,), "float32", nan=True)
    q[::4] = np.nan
    queries = to_torch(q, dtype)
    got = ops.searchsorted(rows, queries, side=side, valid_len=70)
    assert (got[:, ::4] == 0).all()
    for r in range(4):
        want = jops.searchsorted(to_jax(rows[r]), to_jax(queries), side=side,
                                 backend="pallas", valid_len=70)
        assert_bitwise(got[r], want)


@pytest.mark.parametrize("valid_len", [None, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_searchsorted_plain_shared_row_equals_expanded(rng, dtype,
                                                       valid_len):
    """``searchsorted_plain`` on a (1, q) row equals it on the row copied
    to every key row; ``searchsorted`` takes either, and the clamp."""
    rows = sorted_rows(rng, (9, 101), dtype, nan=dtype != "int32")
    q = to_torch(edge_keys(rng, (1, 33), dtype, nan=dtype != "int32"), dtype)
    want = bucketize.searchsorted_plain(rows, q.expand(9, -1).contiguous(),
                                        "left", valid_len)
    assert_bitwise(bucketize.searchsorted_plain(rows, q, "left", valid_len),
                   want)
    assert_bitwise(bucketize.searchsorted(rows, q, "left", valid_len), want)
    clamp = bucketize.searchsorted(rows, q.expand(9, -1).contiguous())
    if valid_len is not None:
        clamp = torch.clamp_max(clamp, valid_len)
    assert_bitwise(want, clamp)


def test_searchsorted_rejects_mismatched_query_rows():
    with pytest.raises(ValueError):
        bucketize.searchsorted(torch.zeros(4, 8), torch.zeros(3, 2))


# ---------------------------------------------------------------------------
# in-tile merges of ragged landed rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("t,c", [(1, 7), (3, 5), (5, 77), (6, 33), (3, 1)])
def test_padded_slots_equal_reference_padding(rng, t, c, dtype):
    """The merge kernel's slot-by-slot padding (``_padded_slots``) equals
    ``_pad_sorted_rows`` and ``_pad_iota_unique``, the port's and the
    reference's."""
    x = sorted_rows(rng, (2, t, c), dtype)
    keys, ids, cp2 = bitonic._padded_slots(x)
    kp = bitonic._pad_sorted_rows(x, bitonic.sort_sentinel(x.dtype))
    tp2 = kp.shape[1]
    assert kp.shape[2] == cp2 and keys.shape == (2, tp2 * cp2)
    assert_bitwise(keys, kp.reshape(2, -1))
    assert_bitwise(ids, bitonic._pad_iota_unique(t, c, tp2, cp2).reshape(-1))
    assert_bitwise(ids, np.asarray(jbitonic._pad_iota_unique(t, c, tp2, cp2))
                   .reshape(-1))
    sentinel = jbitonic.sort_sentinel(to_jax(x).dtype)
    for b in range(2):
        want = jbitonic._pad_sorted_rows(to_jax(x[b]), sentinel)
        assert_bitwise(keys[b], np.asarray(want).reshape(-1))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("t,c", [(3, 5), (5, 77), (6, 33), (7, 1)])
def test_ragged_merges_match_reference(rng, t, c, nan):
    """Both merges of (2, t, c) rows at non-power-of-two t and c, with
    duplicates, +-inf, +-0, denormals and NaN keys: the argsort merge
    bitwise the reference's (keys and order), and the keys-only merge
    the reference's after the denormal flush XLA's CPU applies to that
    network's output (C1).  Without NaN the keys are the input's,
    moved; a NaN key sorts past the pads' sentinels, so the first t*c
    merged positions, all that either side keeps, may hold pads."""
    x = sorted_rows(rng, (2, t, c), "float32", nan)
    merged, order = bitonic.merge_sorted_rows_argsort(x)
    keys = bitonic.merge_sorted_rows(x)
    assert keys.shape == merged.shape == order.shape == (2, t * c)
    for b in range(2):
        wk, wo = jbitonic.merge_sorted_rows_argsort(to_jax(x[b]))
        assert_bitwise(merged[b], wk)
        assert_bitwise(order[b], wo)
        want = to_torch_bits(jbitonic.merge_sorted_rows(to_jax(x[b])),
                             x.dtype)
        assert_bitwise(bitonic.ftz(keys[b]), bitonic.ftz(want))
        if not nan:
            # the keys are the input's, moved: x.flat[order]
            assert_bitwise(merged[b], x[b].reshape(-1)[order[b].long()])
            np.testing.assert_array_equal(np.sort(bits(keys[b])),
                                          np.sort(bits(x[b]).reshape(-1)))


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_ragged_merges_other_dtypes_match_reference(rng, dtype):
    x = sorted_rows(rng, (3, 6, 19), dtype, nan=dtype != "int32")
    merged, order = bitonic.merge_sorted_rows_argsort(x)
    keys = ops.merge_sorted_rows(x)
    for b in range(3):
        wk, wo = jbitonic.merge_sorted_rows_argsort(to_jax(x[b]))
        assert_bitwise(merged[b], wk)
        assert_bitwise(order[b], wo)
        want = to_torch_bits(jbitonic.merge_sorted_rows(to_jax(x[b])),
                             x.dtype)
        assert_bitwise(bitonic.ftz(keys[b]), bitonic.ftz(want))


# ---------------------------------------------------------------------------
# On the card: one C call, one launch, bitwise the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("t,c", [(8, 1077), (3, 1001), (6, 77), (8, 2817),
                                 (16, 4096), (1, 5000), (64, 4096)])
def test_cuda_merges_one_call_equal_plain(card, rng, dtype, t, c):
    """One block, a cluster of CTAs, and (past 2^16 padded slots) the
    global passes: one C call each, bitwise the plain version."""
    x = sorted_rows(rng, (1 if t * c > 1 << 16 else 2, t, c), dtype,
                    nan=dtype != "int32")
    xc = x.to(card)
    cuda.reset_launches()
    got = bitonic.merge_sorted_rows_argsort(xc)
    keys = bitonic.merge_sorted_rows(xc)
    assert cuda.LAUNCHES == {"merge_rows_kv": 1, "merge_rows": 1}
    want = bitonic.merge_sorted_rows_argsort_plain(x)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    assert_bitwise(keys, bitonic.merge_sorted_rows_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("valid_len", [None, 3000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_cuda_shared_row_search_one_call_equal_plain(card, rng, dtype,
                                                     valid_len):
    rows = sorted_rows(rng, (64, 5000), dtype, nan=dtype != "int32")
    q = to_torch(edge_keys(rng, (63,), dtype, nan=dtype != "int32"), dtype)
    cuda.reset_launches()
    got = ops.searchsorted(rows.to(card), q.to(card), valid_len=valid_len)
    assert cuda.LAUNCHES == {"searchsorted": 1}
    assert_bitwise(got, ops.searchsorted(rows, q, valid_len=valid_len))


@pytest.mark.cuda
def test_cuda_launch_takes_the_current_stream(card):
    """The raw stream handle a launch passes is the current stream's,
    inside a ``torch.cuda.stream`` context too."""
    device, raw_stream = cuda._stream_accessor()
    assert raw_stream(device()) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert raw_stream(device()) == side.cuda_stream
        out = ops.searchsorted(torch.arange(8.0, device=card)[None],
                               torch.tensor([2.5], device=card))
    side.synchronize()
    assert out.tolist() == [[3]]
