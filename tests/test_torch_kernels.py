"""The port's kernels (plain versions on the CPU) against the reference's.

Each kernel of ``repro_torch.kernels`` runs here as its plain PyTorch
version and is held bitwise against the JAX function it ports -- the
Pallas kernel in interpret mode and, through ``repro.kernels.ops``, the
jnp reference backend -- on the same seeded numpy inputs.  Tests marked
``cuda`` hold each CUDA kernel against its plain version on the card
and skip where there is none.

One stated difference: XLA's CPU flushes denormal *outputs* of the
reference's bitonic network to zero of the same sign (its selects run
under flush-to-zero), while the port only moves data, so its output is
a permutation of its input.  Comparisons agree (both fold denormals to
zero), so positions agree: the denormal test holds ``ftz(port)``
against the reference bitwise and checks the port's permutation.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bitonic as jbitonic
from repro.kernels import bucketize as jbucketize
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro_torch.kernels import bitonic, bucketize, cuda, fused, ops, ref


def bits(a) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def keys_f32(rng, shape, case):
    """Float keys: gaussian, heavy duplicates, all equal, +-inf mixed in."""
    x = rng.normal(size=shape).astype(np.float32)
    if case == "dups":
        x = rng.choice(np.float32([-1.5, 0.0, 2.25]), size=shape)
    elif case == "equal":
        x = np.full(shape, 3.75, np.float32)
    elif case == "inf":
        flat = x.reshape(-1)
        flat[rng.integers(0, flat.size, max(1, flat.size // 8))] = np.inf
        flat[rng.integers(0, flat.size, max(1, flat.size // 8))] = -np.inf
    return x


# ---------------------------------------------------------------------------
# bitonic_sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "dups", "equal", "inf"])
@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_bitonic_sort_matches_reference(rng, case, n):
    x = keys_f32(rng, (3, n), case)
    got = bitonic.bitonic_sort(torch.from_numpy(x))
    assert_bitwise(got, jbitonic.bitonic_sort(jnp.asarray(x), block_rows=1))
    assert_bitwise(got, jnp.sort(jnp.asarray(x), axis=-1))
    assert_bitwise(ref.sort_ref(torch.from_numpy(x)), got)


@pytest.mark.parametrize("n", [7, 100])
def test_bitonic_sort_int32_matches_reference(rng, n):
    x = rng.integers(-20, 20, (2, n)).astype(np.int32)
    x[0, 0] = np.iinfo(np.int32).max
    x[1, -1] = np.iinfo(np.int32).min
    got = bitonic.bitonic_sort(torch.from_numpy(x))
    assert_bitwise(got, jbitonic.bitonic_sort(jnp.asarray(x), block_rows=1))


def test_bitonic_sort_denormals_and_signed_zeros(rng):
    x = rng.normal(size=(2, 37)).astype(np.float32)
    x[0, :8] = np.float32([1e-40, 0.0, -1e-40, -0.0, 2e-39, -3e-39, 5e-41,
                           -0.0])
    x[1, :4] = np.float32([np.inf, -np.inf, -0.0, 7e-41])
    got = bitonic.bitonic_sort(torch.from_numpy(x))
    want = jbitonic.bitonic_sort(jnp.asarray(x), block_rows=1)
    assert_bitwise(bitonic.ftz(got), want)
    # the port moves data only: each row is a permutation of its input
    np.testing.assert_array_equal(np.sort(bits(got), axis=1),
                                  np.sort(bits(x), axis=1))


@pytest.mark.parametrize("n", [5, 256])
def test_ops_sort_matches_both_reference_backends(rng, n):
    x = keys_f32(rng, (4, n), "normal")
    ops.reset_dispatch_counts()
    got = ops.sort(torch.from_numpy(x))
    for backend in ("pallas", "reference"):
        assert_bitwise(got, jops.sort(jnp.asarray(x), backend=backend))
    padded = ops.sort(ops.pad_pow2(torch.from_numpy(x)), prepadded=True)
    assert_bitwise(padded[:, :n], got)
    assert ops.DISPATCH_COUNTS[("sort", "plain")] == 2


# ---------------------------------------------------------------------------
# searchsorted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,q", [(1, 4), (9, 33), (300, 7)])
def test_searchsorted_matches_reference(rng, side, n, q):
    arr = np.sort(rng.integers(-5, 5, n)).astype(np.float32)   # duplicates
    queries = rng.integers(-7, 7, q).astype(np.float32)
    queries[0] = np.inf
    got = bucketize.searchsorted(torch.from_numpy(arr)[None],
                                 torch.from_numpy(queries)[None], side=side)
    want = jbucketize.searchsorted(jnp.asarray(arr), jnp.asarray(queries),
                                   side=side)
    assert got.dtype == torch.int32
    assert_bitwise(got[0], want)
    assert_bitwise(ref.searchsorted_ref(torch.from_numpy(arr),
                                        torch.from_numpy(queries), side), want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_ops_searchsorted_valid_len_batched(rng, side):
    t, m = 4, 45
    rows = np.sort(rng.integers(0, 9, (t, m)).astype(np.float32), axis=1)
    bounds = np.float32([-1.0, 3.0, 3.0, 8.0, 20.0])         # duplicate bound
    padded = ops.pad_pow2(torch.from_numpy(rows))
    assert padded.shape == (t, 64)
    got = ops.searchsorted(padded, torch.from_numpy(bounds), side=side,
                           valid_len=m)
    assert got.shape == (t, len(bounds)) and got.dtype == torch.int32
    for i in range(t):
        jpad = jops.pad_pow2(jnp.asarray(rows[i]))
        for backend in ("pallas", "reference"):
            want = jops.searchsorted(jpad, jnp.asarray(bounds), side=side,
                                     backend=backend, valid_len=m)
            assert_bitwise(got[i], want)


def test_searchsorted_denormal_queries_fold_to_zero():
    arr = torch.tensor([[0.0, 1.0]])
    q = torch.tensor([[1e-40, -1e-40]])
    want = jbucketize.searchsorted(jnp.asarray([0.0, 1.0], jnp.float32),
                                   jnp.asarray([1e-40, -1e-40], jnp.float32))
    assert_bitwise(bucketize.searchsorted(arr, q)[0], want)
    assert bucketize.searchsorted(arr, q).tolist() == [[0, 0]]


# ---------------------------------------------------------------------------
# merge_sorted_rows (in-tile bitonic merge)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,c", [(1, 9), (2, 5), (3, 16), (8, 37)])
@pytest.mark.parametrize("case", ["normal", "dups", "inf"])
def test_merge_sorted_rows_matches_reference(rng, t, c, case):
    x = np.sort(keys_f32(rng, (t, c), case), axis=1)
    got = bitonic.merge_sorted_rows(torch.from_numpy(x))
    assert_bitwise(got, jbitonic.merge_sorted_rows(jnp.asarray(x)))
    for backend in ("pallas", "reference"):
        assert_bitwise(ops.merge_sorted_rows(torch.from_numpy(x)),
                       jops.merge_sorted_rows(jnp.asarray(x),
                                              backend=backend))


def test_merge_sorted_rows_batched_equals_per_machine(rng):
    x = np.sort(keys_f32(rng, (3, 4, 21), "dups"), axis=-1)
    got = bitonic.merge_sorted_rows(torch.from_numpy(x))
    assert got.shape == (3, 84)
    for b in range(3):
        assert_bitwise(got[b], jbitonic.merge_sorted_rows(jnp.asarray(x[b])))


# ---------------------------------------------------------------------------
# merge_ranks (rank merge past one tile)
# ---------------------------------------------------------------------------

def _ranked_rows(rng, t, c, dtype):
    if dtype == "int32":
        k = np.sort(rng.integers(-4, 4, (t, c)).astype(np.int32), axis=1)
    else:
        k = np.sort(keys_f32(rng, (t, c), "dups"), axis=1)
    kp = np.array(jbitonic._pad_sorted_rows(jnp.asarray(k),
                                              jbitonic.sort_sentinel(k.dtype)))
    tp2, cp2 = kp.shape
    ip = np.array(jbitonic._pad_iota_unique(t, c, tp2, cp2))
    return kp, ip


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("bound_block", [None, 2])
@pytest.mark.parametrize("t,c", [(2, 5), (4, 16), (3, 33)])
def test_merge_ranks_matches_reference(rng, dtype, bound_block, t, c):
    kp, ip = _ranked_rows(rng, t, c, dtype)
    got = fused.merge_ranks(torch.from_numpy(kp)[None],
                            torch.from_numpy(ip)[None],
                            bound_block=bound_block)
    want = jfused.merge_ranks(jnp.asarray(kp), jnp.asarray(ip),
                              bound_block=bound_block)
    assert got.dtype == torch.int32
    assert_bitwise(got[0], want)
    # the ranks are a permutation of the merged positions
    np.testing.assert_array_equal(np.sort(bits(got).reshape(-1)),
                                  np.arange(kp.size))


def test_rank_merge_scatter_matches_reference(rng):
    x = np.sort(keys_f32(rng, (2, 6, 40), "dups"), axis=-1)
    got, _ = ops._rank_merge(torch.from_numpy(x))
    for b in range(2):
        merged, _ = jops._rank_merge(jnp.asarray(x[b]))
        assert_bitwise(got[b], merged)


# ---------------------------------------------------------------------------
# bitonic_sort_kv (the pair sort; fed arange, the stable argsort)
# ---------------------------------------------------------------------------

DENORMALS = np.float32([1e-40, 0.0, -1e-40, -0.0, 2e-39, -3e-39, 5e-41,
                        -0.0])


def kv_keys(rng, shape, dtype, case):
    if dtype == "int32":
        x = rng.integers(-4, 4, shape).astype(np.int32)
        if case == "masked":
            x.reshape(-1)[::3] = np.iinfo(np.int32).max      # MASKED_KEY
        return x
    if case == "denormals":
        return rng.choice(np.concatenate([DENORMALS, [1.5, -2.0]]),
                          size=shape).astype(np.float32)
    return keys_f32(rng, shape, case)


@pytest.mark.parametrize("dtype, case", [
    ("float32", "normal"), ("float32", "dups"), ("float32", "equal"),
    ("float32", "inf"), ("float32", "denormals"), ("int32", "ties"),
    ("int32", "masked")])
@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_bitonic_sort_kv_matches_reference(rng, dtype, case, n):
    """The stable argsort: keys and the order channel bitwise equal to
    the Pallas pair sort and to a stable jnp.argsort."""
    k = kv_keys(rng, (3, n), dtype, case)
    iota = np.tile(np.arange(n, dtype=np.int32), (3, 1))
    gk, gv = bitonic.bitonic_sort_kv(torch.from_numpy(k),
                                     torch.from_numpy(iota))
    wk, wv = jbitonic.bitonic_sort_kv(jnp.asarray(k), jnp.asarray(iota),
                                      block_rows=1)
    assert gv.dtype == torch.int32
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)
    assert_bitwise(gv, jnp.argsort(jnp.asarray(k), axis=-1, stable=True))
    rk, rv = ref.sort_kv_ref(torch.from_numpy(k), torch.from_numpy(iota))
    assert_bitwise(rk, gk)
    assert_bitwise(rv, gv)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_bitonic_sort_kv_with_tied_values_matches_reference(rng, dtype):
    """Arbitrary values: equal (key, value) pairs, the pad sentinel in
    both channels, and a row that is not a power of two."""
    k = kv_keys(rng, (4, 77), dtype, "dups" if dtype == "float32" else "ties")
    v = rng.integers(0, 3, (4, 77)).astype(np.int32)
    v[0, :5] = np.iinfo(np.int32).max
    gk, gv = bitonic.bitonic_sort_kv(torch.from_numpy(k), torch.from_numpy(v))
    wk, wv = jbitonic.bitonic_sort_kv(jnp.asarray(k), jnp.asarray(v),
                                      block_rows=1)
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)


@pytest.mark.parametrize("trailing", [(), (3,)])
@pytest.mark.parametrize("n", [5, 256])
def test_ops_sort_kv_matches_both_reference_backends(rng, n, trailing):
    k = keys_f32(rng, (4, n), "dups")
    v = rng.normal(size=(4, n) + trailing).astype(np.float32)
    ops.reset_dispatch_counts()
    gk, gv = ops.sort_kv(torch.from_numpy(k), torch.from_numpy(v))
    assert gv.shape == (4, n) + trailing
    for i in range(4):
        for backend in ("pallas", "reference"):
            wk, wv = jops.sort_kv(jnp.asarray(k[i]), jnp.asarray(v[i]),
                                  backend=backend)
            assert_bitwise(gk[i], wk)
            assert_bitwise(gv[i], wv)
    pk = ops.pad_pow2(torch.from_numpy(k))
    pv = ops.pad_pow2(torch.from_numpy(v), fill=0, axis=1)
    sk, sv = ops.sort_kv(pk, pv, prepadded=True)
    assert_bitwise(sk[:, :n], gk)
    assert_bitwise(sv[:, :n], gv)
    k1, v1 = ops.sort_kv(torch.from_numpy(k[0]), torch.from_numpy(v[0]))
    assert_bitwise(k1, gk[0])
    assert_bitwise(v1, gv[0])
    assert ops.DISPATCH_COUNTS[("sort_kv", "plain")] == 3


# ---------------------------------------------------------------------------
# The argsort merge and the rank merge's order channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,c", [(1, 9), (2, 5), (3, 16), (8, 37)])
@pytest.mark.parametrize("case", ["dups", "inf", "denormals", "int32"])
def test_merge_sorted_rows_argsort_matches_reference(rng, t, c, case):
    k = (kv_keys(rng, (t, c), "int32", "masked") if case == "int32"
         else kv_keys(rng, (t, c), "float32", case))
    x = np.sort(k, axis=1)
    gm, go = bitonic.merge_sorted_rows_argsort(torch.from_numpy(x))
    wm, wo = jbitonic.merge_sorted_rows_argsort(jnp.asarray(x))
    assert go.dtype == torch.int32
    assert_bitwise(gm, wm)
    assert_bitwise(go, wo)
    assert_bitwise(go, jnp.argsort(jnp.asarray(x).reshape(-1), stable=True))


def test_merge_sorted_rows_argsort_batched_equals_per_machine(rng):
    x = np.sort(keys_f32(rng, (3, 4, 21), "dups"), axis=-1)
    gm, go = bitonic.merge_sorted_rows_argsort(torch.from_numpy(x))
    assert gm.shape == go.shape == (3, 84)
    for b in range(3):
        wm, wo = jbitonic.merge_sorted_rows_argsort(jnp.asarray(x[b]))
        assert_bitwise(gm[b], wm)
        assert_bitwise(go[b], wo)


@pytest.mark.parametrize("t,c", [(2, 5), (6, 40), (3, 70)])
def test_rank_merge_order_channel_matches_reference(rng, t, c):
    x = np.sort(keys_f32(rng, (2, t, c), "dups"), axis=-1)
    gm, go = ops._rank_merge(torch.from_numpy(x), with_order=True)
    for b in range(2):
        wm, wo = jops._rank_merge(jnp.asarray(x[b]))
        assert_bitwise(gm[b], wm)
        assert_bitwise(go[b], wo)
    assert ops._rank_merge(torch.from_numpy(x))[1] is None


@pytest.mark.parametrize("t,c", [(3, 16), (8, 37)])
def test_ops_merge_sorted_rows_kv_matches_both_reference_backends(rng, t, c):
    x = np.sort(keys_f32(rng, (t, c), "dups"), axis=1)
    v = rng.integers(-9, 9, (t, c, 2)).astype(np.int32)
    ops.reset_dispatch_counts()
    gm, gv = ops.merge_sorted_rows_kv(torch.from_numpy(x),
                                      torch.from_numpy(v))
    assert gv.shape == (t * c, 2)
    for backend in ("pallas", "reference"):
        wm, wv = jops.merge_sorted_rows_kv(jnp.asarray(x), jnp.asarray(v),
                                           backend=backend)
        assert_bitwise(gm, wm)
        assert_bitwise(gv, wv)
    rm, rv = ref.merge_sorted_rows_kv_ref(torch.from_numpy(x)[None],
                                          torch.from_numpy(v)[None])
    assert_bitwise(rm[0], gm)
    assert_bitwise(rv[0], gv)
    assert ops.DISPATCH_COUNTS[("merge_sorted_rows_kv", "plain")] == 1


def test_ops_merge_sorted_rows_kv_takes_the_rank_merge_past_one_tile(rng):
    """3 rows of 20,000 pad to 4 x 32,768 slots, past MAX_KERNEL_LANES:
    the order comes from the rank merge's scatter."""
    t, c = 3, 20000
    assert not ops._merge_fits_one_tile(t, c)
    x = np.sort(rng.integers(0, 50, (1, t, c)).astype(np.float32), axis=-1)
    v = torch.arange(t * c, dtype=torch.int32).reshape(1, t, c)
    gm, gv = ops.merge_sorted_rows_kv(torch.from_numpy(x), v)
    want = np.argsort(x.reshape(-1), kind="stable")
    np.testing.assert_array_equal(gv[0].numpy(), want)
    np.testing.assert_array_equal(gm[0].numpy(), x.reshape(-1)[want])


# ---------------------------------------------------------------------------
# The fused sort-and-partition, keys and pairs
# ---------------------------------------------------------------------------

def partition_keys(rng, shape, dtype, case):
    """Keys for the fused sort: heavy duplicates, presorted, reversed,
    all equal or with data infs; int32 from a small domain."""
    if dtype == "int32":
        x = rng.integers(0, max(2, shape[-1] // 8), shape).astype(np.int32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
        x[..., : shape[-1] // 4] = x[..., :1]             # heavy duplicates
        if case == "inf":
            x[..., -3:] = np.inf
    if case == "sorted":
        x = np.sort(x, axis=-1)
    elif case == "reversed":
        x = np.ascontiguousarray(np.sort(x, axis=-1)[..., ::-1])
    elif case == "equal":
        x[:] = x[..., :1]
    return x


def interior_of(rng, x, t):
    """t-1 ascending boundaries drawn from a row's own keys."""
    return np.sort(rng.choice(x[0], t - 1)).astype(x.dtype)


@pytest.mark.parametrize("case", ["dups", "sorted", "reversed", "equal",
                                  "inf"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("m,t", [(192, 4), (1024, 8), (100, 6), (7, 3)])
def test_sort_partition_matches_reference(rng, m, t, dtype, case):
    """Sorted rows and cuts bitwise equal to the Pallas kernel, row by
    row, and to the unfused jnp chain; ``ops`` to both backends."""
    x = partition_keys(rng, (2, m), dtype, case)
    bounds = interior_of(rng, x, t)
    q = torch.from_numpy(np.tile(bounds, (2, 1)))
    xs, cuts = fused.sort_partition(torch.from_numpy(x), q)
    assert cuts.dtype == torch.int32
    ops.reset_dispatch_counts()
    oxs, starts, lens = ops.sort_partition(torch.from_numpy(x),
                                           torch.from_numpy(bounds))
    assert ops.DISPATCH_COUNTS[("sort_partition", "plain")] == 1
    assert_bitwise(oxs, xs)
    for r in range(2):
        wxs, wcuts = jfused.sort_partition(jnp.asarray(x[r]),
                                           jnp.asarray(bounds))
        assert_bitwise(xs[r], wxs)
        assert_bitwise(cuts[r], wcuts)
        for backend in ("pallas", "reference"):
            want = jops.sort_partition(jnp.asarray(x[r]), jnp.asarray(bounds),
                                       backend=backend)
            for got, w in zip((oxs[r], starts[r], lens[r]), want):
                assert_bitwise(got, w)
    rxs, rcuts = ref.sort_partition_ref(torch.from_numpy(x), q)
    assert_bitwise(rxs, xs)
    assert_bitwise(rcuts, cuts)


@pytest.mark.parametrize("case", ["dups", "reversed", "inf"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("m,t", [(192, 4), (1024, 8), (100, 6), (7, 3)])
def test_sort_partition_kv_matches_reference(rng, m, t, dtype, case):
    """Keys, the stable order and the cuts bitwise equal to the Pallas
    kernel; ``ops`` with trailing values to both backends."""
    k = partition_keys(rng, (2, m), dtype, case)
    bounds = interior_of(rng, k, t)
    q = torch.from_numpy(np.tile(bounds, (2, 1)))
    ks, order, cuts = fused.sort_partition_kv(torch.from_numpy(k), q)
    assert order.dtype == cuts.dtype == torch.int32
    v = rng.integers(0, 1 << 30, (2, m, 3)).astype(np.int32)
    oks, ovs, starts, lens = ops.sort_partition_kv(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bounds))
    assert_bitwise(oks, ks)
    for r in range(2):
        want = jfused.sort_partition_kv(jnp.asarray(k[r]), jnp.asarray(bounds))
        for got, w in zip((ks[r], order[r], cuts[r]), want):
            assert_bitwise(got, w)
        for backend in ("pallas", "reference"):
            want = jops.sort_partition_kv(jnp.asarray(k[r]), jnp.asarray(v[r]),
                                          jnp.asarray(bounds), backend=backend)
            for got, w in zip((oks[r], ovs[r], starts[r], lens[r]), want):
                assert_bitwise(got, w)
    for got, w in zip((ks, order, cuts),
                      ref.sort_partition_kv_ref(torch.from_numpy(k), q)):
        assert_bitwise(got, w)


@pytest.mark.parametrize("m,t", [(192, 4), (333, 7)])
def test_sort_partition_kv_is_the_stable_argsort(rng, m, t):
    k = rng.integers(0, 9, (3, m)).astype(np.int32)
    bounds = np.sort(rng.integers(0, 9, t - 1)).astype(np.int32)
    v = np.tile(np.arange(m, dtype=np.int32), (3, 1))
    ks, vs, starts, lens = ops.sort_partition_kv(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bounds))
    np.testing.assert_array_equal(vs.numpy(),
                                  np.argsort(k, axis=1, kind="stable"))
    np.testing.assert_array_equal(lens.sum(1).numpy(), [m] * 3)
    np.testing.assert_array_equal(
        starts[:, 1:].numpy(),
        [np.searchsorted(row, bounds, side="left") for row in ks.numpy()])


def test_sort_partition_empty_interior():
    """t = 1: no boundaries -- it sorts, one segment, and no fused
    kernel runs (as in the reference)."""
    x = torch.tensor([[3.0, 1.0, 2.0]])
    ops.reset_dispatch_counts()
    xs, starts, lens = ops.sort_partition(x, torch.zeros(0))
    np.testing.assert_array_equal(xs.numpy(), [[1.0, 2.0, 3.0]])
    assert starts.tolist() == [[0]] and lens.tolist() == [[3]]
    ks, vs, starts, lens = ops.sort_partition_kv(
        x[0], torch.tensor([7, 8, 9]), torch.zeros(0))
    assert vs.tolist() == [8, 9, 7] and lens.tolist() == [3]
    assert ("sort_partition", "plain") not in ops.DISPATCH_COUNTS
    assert ops.DISPATCH_COUNTS[("sort", "plain")] == 1
    assert ops.DISPATCH_COUNTS[("sort_kv", "plain")] == 1


def test_sort_partition_edge_keys_and_queries_match_reference(rng):
    """+-0 and denormals (compared flushed), queries equal to a key,
    to the sentinel and to -inf; int32 with INT32_MAX keys and query."""
    x = rng.normal(size=(2, 37)).astype(np.float32)
    x[0, :8] = DENORMALS[:8]
    x[1, :5] = np.float32([np.inf, -np.inf, -0.0, 7e-41, 0.0])
    bounds = np.float32([-np.inf, -1e-40, 0.0, x[1, 10], np.inf])
    q = torch.from_numpy(np.tile(bounds, (2, 1)))
    xs, cuts = fused.sort_partition(torch.from_numpy(x), q)
    ks, order, kcuts = fused.sort_partition_kv(torch.from_numpy(x), q)
    for r in range(2):
        wxs, wcuts = jfused.sort_partition(jnp.asarray(x[r]),
                                           jnp.asarray(bounds))
        assert_bitwise(bitonic.ftz(xs[r]), wxs)   # XLA flushes its outputs
        assert_bitwise(cuts[r], wcuts)
        wks, worder, wkcuts = jfused.sort_partition_kv(jnp.asarray(x[r]),
                                                       jnp.asarray(bounds))
        assert_bitwise(ks[r], wks)
        assert_bitwise(order[r], worder)
        assert_bitwise(kcuts[r], wkcuts)
    imax = np.iinfo(np.int32).max
    xi = rng.integers(-5, 5, (2, 50)).astype(np.int32)
    xi[:, ::4] = imax
    bi = np.int32([-5, 0, 0, 4, imax])
    qi = torch.from_numpy(np.tile(bi, (2, 1)))
    xs, cuts = fused.sort_partition(torch.from_numpy(xi), qi)
    ks, order, kcuts = fused.sort_partition_kv(torch.from_numpy(xi), qi)
    for r in range(2):
        assert_bitwise(cuts[r], jfused.sort_partition(
            jnp.asarray(xi[r]), jnp.asarray(bi))[1])
        for got, w in zip((ks[r], order[r], kcuts[r]),
                          jfused.sort_partition_kv(jnp.asarray(xi[r]),
                                                   jnp.asarray(bi))):
            assert_bitwise(got, w)
    assert cuts[0, -1] == (xi[0] < imax).sum()


def test_sort_partition_gate():
    """What is admitted: every width (C10), one key dtype of three.  A
    row past the bitonic tile's reach (2 x 2^17) now returns the
    reference's result -- there its jnp fallback, here a radix sort and
    the search -- where it used to raise."""
    f = torch.zeros
    assert ops.kernel_eligible("sort_partition", f(4, ops.MAX_KERNEL_LANES),
                               f(3))
    assert ops.kernel_eligible("sort_partition_kv", f(4, 8), f(4, 3))
    assert ops.kernel_eligible("sort_partition",
                               f(4, ops.MAX_KERNEL_LANES + 1), f(3))
    assert not ops.kernel_eligible("sort_partition", f(4, 8),
                                   f(3, dtype=torch.int32))
    assert not ops.kernel_eligible("sort_partition", f(4, 8), f(0))
    with pytest.raises(ValueError, match="C10"):
        ops.sort_partition(f(2, 8, dtype=torch.float64),
                           f(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="align"):
        ops.sort_partition_kv(f(2, 8), f(2, 7), f(1))
    n = 2 * ops.MAX_KERNEL_LANES
    x = np.random.default_rng(4).normal(size=(2, n)).astype(np.float32)
    q = np.float32([0.25])
    v = torch.arange(2 * n, dtype=torch.int32).reshape(2, n)
    ops.reset_dispatch_counts()
    ks, vs, starts, lens = ops.sort_partition_kv(torch.from_numpy(x), v,
                                                 torch.from_numpy(q))
    assert ops.DISPATCH_COUNTS[("sort_kv", "radix-plain")] == 1
    for r in range(2):
        wk, wv, ws, wl = jops.sort_partition_kv(
            jnp.asarray(x[r]), jnp.asarray(v[r].numpy()), jnp.asarray(q),
            backend="pallas")
        assert_bitwise(ks[r], wk)
        assert_bitwise(vs[r], wv)
        assert_bitwise(starts[r], ws)
        assert_bitwise(lens[r], wl)


# ---------------------------------------------------------------------------
# The gate and the dispatch rule
# ---------------------------------------------------------------------------

def test_kernel_eligible_gate():
    """What is admitted (float32/bfloat16/int32 keys, any width) apart
    from which kernel runs (MAX_KERNEL_LANES: the bitonic tile's reach
    and the in-tile/rank-merge split).  The operands past the old
    2^16-lane gate -- a (4, 2^16 + 1) sort and pair sort, and t > 512
    rows of 128 to merge -- return the reference's result (its jnp
    fallback there) instead of raising (C10)."""
    f = torch.zeros
    assert ops.kernel_eligible("sort", f(4, ops.MAX_KERNEL_LANES))
    assert ops.kernel_eligible("sort", f(4, ops.MAX_KERNEL_LANES + 1))
    assert ops.kernel_eligible("sort", f(4, 8, dtype=torch.bfloat16))
    assert not ops.kernel_eligible("sort", f(4, 8, dtype=torch.float64))
    assert ops.kernel_eligible("merge_sorted_rows", f(64, 64, 2152))
    assert not ops._merge_fits_one_tile(64, 2152)
    assert ops._merge_fits_one_tile(8, 1077)
    assert ops.kernel_eligible("merge_sorted_rows", f(1024, 128))
    assert not ops._merge_fits_one_tile(1024, 128)
    assert ops.sort_kernel_choice(f(64, 65536)) == "bitonic"
    assert ops.sort_kernel_choice(f(4, ops.MAX_KERNEL_LANES + 1)) == "radix"
    assert ops.kernel_eligible("sort_kv", f(4, 8), f(4, 8, 24))
    assert not ops.kernel_eligible("sort_kv", f(4, 8), f(4, 7))
    assert ops.kernel_eligible("sort_kv", f(4, ops.MAX_KERNEL_LANES + 1))
    assert ops.kernel_eligible("merge_sorted_rows_kv", f(64, 64, 2152),
                               f(64, 64, 2152, 24))
    assert not ops.kernel_eligible("merge_sorted_rows_kv", f(8, 16),
                                   f(8, 15))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, ops.MAX_KERNEL_LANES + 1)).astype(np.float32)
    ks, vs = ops.sort_kv(torch.from_numpy(x), torch.from_numpy(x))
    assert_bitwise(ops.sort(torch.from_numpy(x)), jnp.sort(x, axis=-1))
    for r in range(4):
        wk, wv = jops.sort_kv(jnp.asarray(x[r]), jnp.asarray(x[r]),
                              backend="pallas")
        assert_bitwise(ks[r], wk)
        assert_bitwise(vs[r], wv)
    # t > 512 rows, past one tile: the rank merge (the plain version's
    # work grows as t^2, so 520 rows rather than 1024)
    rows = np.sort(keys_f32(rng, (520, 128), "dups"), axis=-1)
    assert_bitwise(ops.merge_sorted_rows(torch.from_numpy(rows)),
                   jops.merge_sorted_rows(jnp.asarray(rows),
                                          backend="pallas"))


def test_ops_raise_outside_the_gate():
    """Dtypes outside the reference's kernels and the prepadded contract
    still raise (naming C10).  A (2, 2^17) row and a bf16 row, which
    used to raise, give the reference's result: its jnp sort past its
    lane gate, its bitonic kernel on bf16 keys (which flushes denormal
    outputs, as for float32)."""
    x = np.random.default_rng(2).normal(
        size=(2, ops.MAX_KERNEL_LANES * 2)).astype(np.float32)
    assert_bitwise(ops.sort(torch.from_numpy(x)),
                   jops.sort(jnp.asarray(x), backend="pallas"))
    xb = jnp.asarray(x[:, :8]).astype(jnp.bfloat16)
    got = ops.sort(torch.from_numpy(np.asarray(xb).view(np.int16).copy())
                   .view(torch.bfloat16))
    np.testing.assert_array_equal(
        bitonic.ftz(got).view(torch.int16).numpy(),
        np.asarray(jops.sort(xb, backend="pallas")).view(np.int16))
    with pytest.raises(ValueError, match="prepadded"):
        ops.sort(torch.zeros(2, 6), prepadded=True)
    with pytest.raises(ValueError, match="C10"):
        ops.sort_kv(torch.zeros(2, 8, dtype=torch.float64),
                    torch.zeros(2, 8))
    with pytest.raises(ValueError, match="prepadded"):
        ops.sort_kv(torch.zeros(2, 6), torch.zeros(2, 6), prepadded=True)
    with pytest.raises(ValueError, match="C10"):
        ops.merge_sorted_rows_kv(torch.zeros(2, 3, dtype=torch.int64),
                                 torch.zeros(2, 3))


def test_kernel_build_is_not_touched_on_the_cpu(rng):
    x = torch.from_numpy(keys_f32(rng, (2, 50), "normal"))
    cuda.reset_launches()
    ops.sort(x)
    assert not cuda.LAUNCHES


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 4096, 65536])
def test_cuda_bitonic_sort_equals_plain(card, rng, n):
    x = torch.from_numpy(keys_f32(rng, (8, n), "inf"))
    x[0, :4] = torch.tensor([1e-40, -0.0, 0.0, -3e-39])
    assert_bitwise(bitonic.bitonic_sort(x.to(card)), bitonic.bitonic_sort(x))


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
def test_cuda_searchsorted_equals_plain(card, rng, side):
    arr = torch.from_numpy(np.sort(rng.integers(0, 50, (16, 4096)), axis=1)
                           .astype(np.float32))
    q = torch.from_numpy(rng.integers(-1, 52, (16, 15)).astype(np.float32))
    assert_bitwise(bucketize.searchsorted(arr.to(card), q.to(card), side),
                   bucketize.searchsorted(arr, q, side))


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", [(8, 1077), (16, 4096)])
def test_cuda_merges_equal_plain(card, rng, t, c):
    x = torch.from_numpy(np.sort(keys_f32(rng, (2, t, c), "dups"), axis=-1))
    assert_bitwise(ops.merge_sorted_rows(x.to(card)),
                   ops.merge_sorted_rows(x))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 4096, 65536])
def test_cuda_bitonic_sort_kv_equals_plain(card, rng, n):
    k = torch.from_numpy(keys_f32(rng, (8, n), "dups"))
    k[0, :4] = torch.tensor([1e-40, -0.0, 0.0, -3e-39])
    v = torch.arange(n, dtype=torch.int32).repeat(8, 1)
    gk, gv = bitonic.bitonic_sort_kv(k.to(card), v.to(card))
    wk, wv = bitonic.bitonic_sort_kv(k, v)
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)
    ki = torch.from_numpy(kv_keys(rng, (3, n), "int32", "masked"))
    vi = torch.from_numpy(rng.integers(0, 3, (3, n)).astype(np.int32))
    gk, gv = bitonic.bitonic_sort_kv(ki.to(card), vi.to(card))
    wk, wv = bitonic.bitonic_sort_kv(ki, vi)
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", [(8, 1077), (16, 4096)])
def test_cuda_argsort_merges_equal_plain(card, rng, t, c):
    x = torch.from_numpy(np.sort(keys_f32(rng, (2, t, c), "dups"), axis=-1))
    v = torch.arange(t * c, dtype=torch.int32).reshape(1, t, c).repeat(2, 1, 1)
    gm, gv = ops.merge_sorted_rows_kv(x.to(card), v.to(card))
    wm, wv = ops.merge_sorted_rows_kv(x, v)
    assert_bitwise(gm, wm)
    assert_bitwise(gv, wv)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_the_gate_rejects(card, rng):
    """float64 still raises on the card; a (2, 2^17) row, past the old
    gate, sorts there by the radix kernel and equals the CPU's result."""
    x = torch.from_numpy(keys_f32(rng, (2, ops.MAX_KERNEL_LANES * 2),
                                  "dups"))
    cuda.reset_launches()
    got = ops.sort(x.to(card))
    assert cuda.LAUNCHES["radix_sort"] == 1
    assert_bitwise(got, ops.sort(x))
    with pytest.raises(TypeError):
        bitonic.bitonic_sort(torch.zeros(2, 8, dtype=torch.float64,
                                         device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("m,nq", [(7, 2), (100, 5), (2048, 7), (8193, 63),
                                  (65536, 63)])
def test_cuda_sort_partition_equals_plain(card, rng, m, nq):
    """The fused kernels against their plain versions, f32 and int32: one
    tile and many, m not a power of two, a query equal to the sentinel."""
    x = torch.from_numpy(partition_keys(rng, (4, m), "float32", "inf"))
    x[0, :4] = torch.tensor([1e-40, -0.0, 0.0, -3e-39])
    q = torch.sort(x[:, torch.randperm(m)[:nq]], dim=1).values
    q[:, -1] = np.inf
    xi = torch.from_numpy(partition_keys(rng, (4, m), "int32", "dups"))
    xi[1, ::5] = np.iinfo(np.int32).max
    qi = torch.sort(xi[:, torch.randperm(m)[:nq]], dim=1).values
    qi[:, -1] = np.iinfo(np.int32).max
    for keys, queries in ((x, q), (xi, qi)):
        got = fused.sort_partition(keys.to(card), queries.to(card))
        for g, w in zip(got, fused.sort_partition_plain(keys, queries)):
            assert_bitwise(g, w)
        got = fused.sort_partition_kv(keys.to(card), queries.to(card))
        for g, w in zip(got, fused.sort_partition_kv_plain(keys, queries)):
            assert_bitwise(g, w)
