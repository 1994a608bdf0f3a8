"""The port's fused bucketize + histogram against the reference's.

``bucketize_histogram_plain`` (the kernel's plain version) and
``ops.bucketize_histogram`` are held **bitwise** against the reference's
Pallas kernel in interpret mode (``repro.kernels.bucketize``) and its
``ops.bucketize_histogram`` by both backends: ids and counts are
integers.  Covered: float32 and int32 keys; t in {1, 2, 6, 10, 64};
duplicate boundaries; keys equal to boundaries; +-inf, NaN, +-0 and
denormal keys (XLA and the port both compare denormals as zero); n a
multiple of no block.

One stated difference, in the reference itself: a NaN key lands in
bucket 0 under its Pallas kernel (every ``bound <= NaN`` is false) and
in the last bucket under its jnp backend (``jnp.searchsorted`` orders
NaN last, as ``jnp.sort`` does).  The port is the kernel's counterpart
and follows the Pallas kernel; against the jnp backend the ids agree at
every key that is not NaN, and the counts on keys with no NaN.  Tests
marked ``cuda`` hold the CUDA kernel against its plain version on the
card, bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bucketize as jbucketize
from repro.kernels import ops as jops
from repro_torch.kernels import bucketize, cuda, ops

TS = [1, 2, 6, 10, 64]


def keys_and_bounds(rng, dtype, n, t):
    """Keys with every awkward class; t-1 ascending boundaries with
    duplicates, drawn from the keys so that some keys equal them."""
    if dtype == np.int32:
        keys = rng.integers(-50, 50, n).astype(np.int32)
        keys[::17] = np.iinfo(np.int32).max
        keys[5::19] = np.iinfo(np.int32).min
    else:
        keys = rng.standard_normal(n).astype(np.float32)
        special = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40,
                              -1e-40, 2e-39])
        keys[::7] = special[rng.integers(0, len(special), len(keys[::7]))]
    finite = keys[np.isfinite(keys)] if dtype == np.float32 else keys
    bounds = np.sort(rng.choice(finite, t - 1)).astype(dtype)
    if t > 3:
        bounds[1] = bounds[2]                  # a duplicate boundary
    if dtype == np.float32 and t > 2:
        bounds[0] = -1e-40                      # a denormal boundary
        bounds = np.sort(bounds)
    return keys, bounds


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bucketize_histogram_matches_reference(rng, dtype, t):
    n = 2500                      # 2.44 of the reference's 1024-key blocks
    keys, bounds = keys_and_bounds(rng, dtype, n, t)
    jk, jb = jnp.asarray(keys), jnp.asarray(bounds)
    want = jbucketize.bucketize_histogram(jk, jb, t, interpret=True)
    want_ops = jops.bucketize_histogram(jk, jb, t, backend="pallas")
    jnp_ids, _ = jops.bucketize_histogram(jk, jb, t, backend="reference")
    real = ~np.isnan(keys) if dtype == np.float32 else slice(None)
    kt, bt = torch.from_numpy(keys), torch.from_numpy(bounds)
    ops.reset_dispatch_counts()
    for ids, counts in (bucketize.bucketize_histogram_plain(kt, bt, t),
                        ops.bucketize_histogram(kt, bt, t)):
        assert ids.dtype == counts.dtype == torch.int32
        for w_ids, w_counts in (want, want_ops):
            np.testing.assert_array_equal(ids.numpy(), np.asarray(w_ids))
            np.testing.assert_array_equal(counts.numpy(),
                                          np.asarray(w_counts))
        np.testing.assert_array_equal(ids.numpy()[real],
                                      np.asarray(jnp_ids)[real])
    assert ops.DISPATCH_COUNTS[("bucketize_histogram", "plain")] == 1
    assert int(counts.sum()) == n


@pytest.mark.parametrize("t", [2, 10])
def test_counts_match_the_jnp_backend_without_nan(rng, t):
    keys, bounds = keys_and_bounds(rng, np.float32, 3000, t)
    keys = np.where(np.isnan(keys), np.float32(1.5), keys)
    _, want = jops.bucketize_histogram(jnp.asarray(keys), jnp.asarray(bounds),
                                       t, backend="reference")
    _, got = ops.bucketize_histogram(torch.from_numpy(keys),
                                     torch.from_numpy(bounds), t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nan_keys_land_in_bucket_zero_as_under_the_pallas_kernel():
    keys = np.float32([np.nan, 0.5, 2.0, np.nan])
    bounds = np.float32([0.0, 1.0])
    want_ids, want_counts = jbucketize.bucketize_histogram(
        jnp.asarray(keys), jnp.asarray(bounds), 3, interpret=True)
    ids, counts = ops.bucketize_histogram(torch.from_numpy(keys),
                                          torch.from_numpy(bounds), 3)
    assert ids.tolist() == np.asarray(want_ids).tolist() == [0, 1, 2, 0]
    assert counts.tolist() == np.asarray(want_counts).tolist() == [2, 1, 1]


def test_outside_the_gate_or_contract_raises():
    """Mixed dtypes, 2-D keys and a wrong boundary count still raise.
    2^16 + 1 boundaries, past the reference's lane gate, used to raise
    here (C10); the kernel takes any count, and the same operands give
    the reference's ids and counts (its jnp path there)."""
    k = torch.zeros(8)
    with pytest.raises(ValueError, match="C10"):
        ops.bucketize_histogram(k, torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="C10"):
        ops.bucketize_histogram(k[None], torch.zeros(3), 4)
    n_b = ops.MAX_KERNEL_LANES + 1
    ids, counts = ops.bucketize_histogram(k, torch.zeros(n_b), n_b + 1)
    want_ids, want_counts = jops.bucketize_histogram(
        jnp.zeros(8), jnp.zeros(n_b), n_b + 1, backend="pallas")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert counts[-1] == 8
    with pytest.raises(ValueError, match="t - 1"):
        ops.bucketize_histogram(k, torch.zeros(3), 5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", TS + [20000])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bucketize_kernel_matches_plain_on_the_card(card, rng, dtype, t):
    """Bitwise, at a size that spans many blocks; t = 20,000 takes the
    global-counter path (past the shared-memory histogram)."""
    keys, bounds = keys_and_bounds(rng, dtype, 300_001, t)
    kt, bt = torch.from_numpy(keys).to(card), torch.from_numpy(bounds).to(card)
    cuda.reset_launches()
    ids, counts = bucketize.bucketize_histogram(kt, bt, t)
    assert cuda.LAUNCHES["bucketize_histogram"] == (t > 1)
    want_ids, want_counts = bucketize.bucketize_histogram_plain(kt, bt, t)
    assert torch.equal(ids, want_ids) and torch.equal(counts, want_counts)


def card_keys(rng, dtype, n):
    """Keys of every class (NaN, +-inf, +-0, denormals, int32 extremes)
    as a torch operand of ``dtype``, and the keys the bounds come from."""
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    keys, _ = keys_and_bounds(rng, np_dtype, n, 2)
    kt = torch.from_numpy(keys)
    return kt.to(torch.bfloat16) if dtype == torch.bfloat16 else kt


def card_bounds(keys: torch.Tensor, t: int) -> torch.Tensor:
    """t - 1 ascending boundaries drawn from the finite keys, with a
    duplicate where t > 3."""
    finite = torch.sort(keys[torch.isfinite(keys.float())]).values
    b = finite[torch.linspace(0, len(finite) - 1, t + 1)[1:-1].long()]
    if t > 3:
        b[1] = b[2]
    return b.contiguous()


CARD_DTYPES = [torch.float32, torch.bfloat16, torch.int32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES, ids=str)
def test_bucketize_kernel_tails_and_views_on_the_card(card, rng, dtype):
    """Every n from 0 to 33 and 4,194,305 (no whole 16-byte vector, and
    a tail past the vectors), and views at offsets 1 and 3 (a data_ptr
    off 16 bytes: the kernel's scalar head): ids and counts bitwise the
    plain version's, one launch a call."""
    keys = card_keys(rng, dtype, 4_194_305 + 3).to(card)
    bounds = card_bounds(keys, 64)
    views = [keys[:n] for n in [*range(34), 4_194_305]]
    views += [keys[1:], keys[3:]]
    assert keys[1:].data_ptr() % 16 and keys[3:].data_ptr() % 16
    for view in views:
        cuda.reset_launches()
        ids, counts = bucketize.bucketize_histogram(view, bounds, 64)
        assert dict(cuda.LAUNCHES) == {"bucketize_histogram": 1}
        want_ids, want_counts = bucketize.bucketize_histogram_plain(
            view, bounds, 64)
        assert torch.equal(ids, want_ids) and torch.equal(counts, want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2, 3, 64, 257, 4097, 12289])
@pytest.mark.parametrize("dtype", CARD_DTYPES, ids=str)
def test_bucketize_kernel_bucket_counts_on_the_card(card, rng, dtype, t):
    """Each warp's own counters (t up to 384), one block histogram
    (4,097) and device-memory counters past SHARED_HIST_MAX (12,289),
    with NaN keys and a duplicate bound, then a NaN bound: bitwise the
    plain version's."""
    keys = card_keys(rng, dtype, 300_001).to(card)
    bounds = card_bounds(keys, t)
    ids, counts = bucketize.bucketize_histogram(keys, bounds, t)
    want_ids, want_counts = bucketize.bucketize_histogram_plain(
        keys, bounds, t)
    assert torch.equal(ids, want_ids) and torch.equal(counts, want_counts)
    if dtype != torch.int32 and t > 2:       # a NaN among the boundaries
        bounds[t // 3] = float("nan")
        ids, counts = bucketize.bucketize_histogram(keys, bounds, t)
        want_ids, want_counts = bucketize.bucketize_histogram_plain(
            keys, bounds, t)
        assert torch.equal(ids, want_ids)
        assert torch.equal(counts, want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES, ids=str)
def test_bucketize_kernel_calls_of_changing_t_on_the_card(card, rng, dtype):
    """Calls on one stream share the kernel's workspace whatever their t:
    past SHARED_HIST_MAX (20,000, 12,289, 16,000), across the 128-byte
    counter lines' reach (385, 384) and back, each call's ids and
    counts bitwise the plain version's."""
    keys = card_keys(rng, dtype, 300_001).to(card)
    for t in (20000, 12289, 20000, 16000, 385, 384, 64, 1025, 20000):
        bounds = card_bounds(keys, t)
        ids, counts = bucketize.bucketize_histogram(keys, bounds, t)
        want_ids, want_counts = bucketize.bucketize_histogram_plain(
            keys, bounds, t)
        assert torch.equal(ids, want_ids), t
        assert torch.equal(counts, want_counts), t
