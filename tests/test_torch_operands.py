"""Every operand the reference's ``ops`` admit, through the port (ROADMAP C10).

* bf16 keys through each sort-side op's plain version against the
  reference's kernel in interpret mode, bitwise: the bitonic sort (whose
  reference, as for float32, flushes denormal outputs: the port is held
  after the same flush), the pair sort, both in-tile merges, the
  search, the histogram, the fused sort-and-cut, the rank merge;
* the cluster front door with bf16 keys, SMMS and Terasort, keys and
  values, against ``repro.cluster.sort``: keys, values and every
  AlphaKReport field;
* a per-machine width past 2^16 (t = 2, m = 2^16 + 3) for
  ``cluster.sort`` and the broadcast join: the reference falls back to
  jnp there, the port runs its radix sort and rank merge;
* float64 and int64 host arrays, which the reference's front door
  narrows to float32 and int32 (JAX's default 32-bit mode).

Tests marked ``cuda`` hold the bf16 kernels and the wide rows on the card
against the plain versions and skip where there is no card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro.kernels import bitonic as jbitonic
from repro.kernels import bucketize as jbucketize
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro_torch import cluster
from repro_torch.data import uniform_keys, zipf_keys
from repro_torch.kernels import bitonic, bucketize, cuda, fused, ops

from test_torch_terasort import assert_reports_equal, reference_uniforms


def bf16(x: np.ndarray):
    """float32 numpy -> (jax bf16, torch bf16) holding the same bits."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, torch.from_numpy(np.asarray(xj).view(np.int16).copy()).view(
        torch.bfloat16)


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


def as_jax(t: torch.Tensor):
    return jnp.asarray(bits(t)).view(jnp.bfloat16)


EDGES = np.float32([0.0, -0.0, 1e-40, -2e-39, np.inf, -np.inf, 1.5, -1.5])


def edge_keys(rng, shape) -> np.ndarray:
    """Gaussian float32 with zeros of both signs, denormals (which bf16
    keeps: its exponent field is float32's), infinities and ties."""
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.integers(0, flat.size, flat.size // 3)
    flat[pick] = rng.choice(EDGES, pick.size)
    return x


def sorted_bf16_rows(rng, shape):
    """bf16 rows sorted in the comparator's order (the port's sort)."""
    _, xt = bf16(edge_keys(rng, shape))
    xt = xt[..., :]
    flat = xt.reshape(-1, shape[-1])
    flat = bitonic.bitonic_sort(flat.contiguous())
    return flat.reshape(shape)


# ---------------------------------------------------------------------------
# bf16 keys, op by op, against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(1, 2), (4, 64), (8, 128), (3, 100),
                                    (16, 1024), (5, 257)])
def test_bitonic_sort_bf16_matches_reference(rows, n):
    """The reference's own bf16 sweep (tests/test_kernels.py:20)."""
    xj = jax.random.normal(jax.random.key(rows * n),
                           (rows, n)).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj).view(np.int16).copy()).view(
        torch.bfloat16)
    got = bitonic.bitonic_sort(xt)
    assert got.dtype == torch.bfloat16
    assert_bitwise(bitonic.ftz(got), jbitonic.bitonic_sort(xj))
    assert_bitwise(bitonic.ftz(got), jnp.sort(xj, axis=-1))


def test_bitonic_sort_bf16_edges_match_reference(rng):
    xj, xt = bf16(edge_keys(rng, (3, 300)))
    got = bitonic.bitonic_sort(xt)
    assert_bitwise(bitonic.ftz(got), jbitonic.bitonic_sort(xj))
    # only moved: each row is a permutation of its input
    np.testing.assert_array_equal(np.sort(bits(got), axis=1),
                                  np.sort(bits(xt), axis=1))
    # the bitonic network orders ties of -0.0, +0.0 and denormals as the
    # reference's network does, not as its stable jnp sort does
    assert_bitwise(bitonic.ftz(ops.sort(xt)), jops.sort(xj, backend="pallas"))


@pytest.mark.parametrize("n", [5, 100])
def test_bitonic_sort_kv_bf16_matches_reference(rng, n):
    xj, xt = bf16(edge_keys(rng, (3, n)))
    iota = np.tile(np.arange(n, dtype=np.int32), (3, 1))
    gk, gv = bitonic.bitonic_sort_kv(xt, torch.from_numpy(iota))
    wk, wv = jbitonic.bitonic_sort_kv(xj, jnp.asarray(iota))
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)
    v = rng.integers(-9, 9, (3, n, 2)).astype(np.int32)
    ks, vs = ops.sort_kv(xt, torch.from_numpy(v))
    for r in range(3):
        want = jops.sort_kv(xj[r], jnp.asarray(v[r]), backend="pallas")
        assert_bitwise(ks[r], want[0])
        assert_bitwise(vs[r], want[1])


@pytest.mark.parametrize("t,c", [(2, 5), (8, 37)])
def test_merges_bf16_match_reference(rng, t, c):
    rows = sorted_bf16_rows(rng, (t, c))
    rj = as_jax(rows)
    assert_bitwise(bitonic.ftz(bitonic.merge_sorted_rows(rows)),
                   jbitonic.merge_sorted_rows(rj))
    gm, go = bitonic.merge_sorted_rows_argsort(rows)
    wm, wo = jbitonic.merge_sorted_rows_argsort(rj)
    assert_bitwise(gm, wm)
    assert_bitwise(go, wo)
    v = torch.arange(t * c, dtype=torch.int32).reshape(t, c)
    km, vm = ops.merge_sorted_rows_kv(rows, v)
    wk, wv = jops.merge_sorted_rows_kv(rj, jnp.asarray(v.numpy()),
                                       backend="reference")
    assert_bitwise(km, wk)
    assert_bitwise(vm, wv)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_bf16_matches_reference(rng, side):
    rows = sorted_bf16_rows(rng, (3, 200))
    qj, qt = bf16(np.float32([-1.5, -0.0, 0.0, 1e-40, 0.5, 1.5, np.inf]))
    got = bucketize.searchsorted(rows, qt.expand(3, -1).contiguous(), side)
    for r in range(3):
        want = jbucketize.searchsorted(as_jax(rows[r]), qj, side=side)
        assert_bitwise(got[r], want)
        assert_bitwise(ops.searchsorted(rows[r], qt, side=side),
                       jops.searchsorted(as_jax(rows[r]), qj, side=side,
                                         backend="reference"))


@pytest.mark.parametrize("side", ["left", "right"])
def test_float32_queries_over_bf16_rows_match_jnp(rng, side):
    """SMMS's boundaries are float32 over bf16 rows; the reference's
    search there promotes both to float32 (its jnp path).  The port
    rounds each query to the bf16 that cuts the row at the same place:
    held on a row of every ordered bf16 value and queries between them,
    at zeros, denormals, past the largest bf16 and at the infinities."""
    pats = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    every = torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16)
    every = every[~torch.isnan(every)]
    row = bitonic.bitonic_sort(every[None])[0]
    q = np.concatenate([
        (rng.normal(size=3000) * 10.0 ** rng.integers(-40, 39, 3000)),
        [0.0, -0.0, 1e-40, -1e-40, 1.17549435e-38, -1.17549435e-38,
         3.3895e38, 3.4e38, -3.4e38, np.inf, -np.inf]]).astype(np.float32)
    got = ops.searchsorted(row, torch.from_numpy(q), side=side)
    want = jnp.searchsorted(as_jax(row), jnp.asarray(q), side=side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bucketize_histogram_bf16_matches_reference(rng):
    kj, kt = bf16(edge_keys(rng, (5000,)))
    bounds = sorted_bf16_rows(rng, (1, 15))[0]
    ids, counts = ops.bucketize_histogram(kt, bounds, 16)
    wi, wc = jbucketize.bucketize_histogram(kj, as_jax(bounds), 16)
    assert_bitwise(ids, wi)
    assert_bitwise(counts, wc)
    assert int(counts.sum()) == 5000


@pytest.mark.parametrize("m,nq", [(100, 3), (300, 7)])
def test_sort_partition_bf16_matches_reference(rng, m, nq):
    xj, xt = bf16(edge_keys(rng, (2, m)))
    qs = sorted_bf16_rows(rng, (1, nq))[0]
    xs, cuts = fused.sort_partition(xt, qs.expand(2, -1).contiguous())
    ks, order, kcuts = fused.sort_partition_kv(xt,
                                               qs.expand(2, -1).contiguous())
    for r in range(2):
        wx, wc = jfused.sort_partition(xj[r], as_jax(qs))
        # in bf16 the reference's fused kernel keeps denormal outputs
        # (its keys-only sort flushes them): equal without the flush
        assert_bitwise(xs[r], wx)
        assert_bitwise(cuts[r], wc)
        for g, w in zip((ks[r], order[r], kcuts[r]),
                        jfused.sort_partition_kv(xj[r], as_jax(qs))):
            assert_bitwise(g, w)


@pytest.mark.parametrize("bound_block", [None, 2])
def test_merge_ranks_bf16_matches_reference(rng, bound_block):
    t, c = 4, 33
    rows = sorted_bf16_rows(rng, (t, c))
    kp = bitonic._pad_sorted_rows(rows, np.inf)
    ip = bitonic._pad_iota_unique(t, c, *kp.shape)
    got = fused.merge_ranks(kp[None], ip[None], bound_block=bound_block)
    want = jfused.merge_ranks(as_jax(kp), jnp.asarray(ip.numpy()),
                              bound_block=bound_block)
    assert_bitwise(got[0], want)


# ---------------------------------------------------------------------------
# the front door with bf16 keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("algorithm, gen", [("smms", uniform_keys),
                                            ("smms", zipf_keys),
                                            ("terasort", uniform_keys)])
def test_cluster_sort_bf16_matches_reference(algorithm, gen, with_values):
    t, m, seed = 4, 192, 3
    xj, xt = bf16(gen(t * m, seed=t + m).reshape(t, m))
    v = (np.arange(t * m, dtype=np.int32).reshape(t, m) if with_values
         else None)
    (wk, wv), want = jcluster.sort(
        xj, algorithm=algorithm, seed=seed,
        values=None if v is None else jnp.asarray(v))
    extra = ({"uniforms": reference_uniforms(seed, t, m)}
             if algorithm == "terasort" else {})
    (gk, gv), rep = cluster.sort(xt, algorithm=algorithm, values=v,
                                 seed=seed, device="cpu", **extra)
    assert gk.dtype == torch.bfloat16
    assert_bitwise(gk, wk)
    if with_values:
        assert_bitwise(gv, wv)
    else:
        assert gv is None and wv is None
    assert_reports_equal(rep, want)


# ---------------------------------------------------------------------------
# rows past 2^16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_cluster_sort_past_2_16_matches_reference(algorithm):
    t, m, seed = 2, (1 << 16) + 3, 1
    x = uniform_keys(t * m, seed=7).reshape(t, m)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    (wk, wv), want = jcluster.sort(jnp.asarray(x), algorithm=algorithm,
                                   values=jnp.asarray(v), seed=seed)
    extra = ({"uniforms": reference_uniforms(seed, t, m)}
             if algorithm == "terasort" else {})
    ops.reset_dispatch_counts()
    (gk, gv), rep = cluster.sort(x, algorithm=algorithm, values=v,
                                 seed=seed, device="cpu", **extra)
    assert ops.DISPATCH_COUNTS[("sort_kv", "radix-plain")] == 1
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)
    assert_reports_equal(rep, want)


def test_broadcast_join_past_2_16_matches_reference(rng):
    """S (the small side, all-gathered) has 2^16 + 3 rows, and each
    machine's T fragment 2^16 + 3: the pair sort and the searches run
    past the old 2^16-lane gate."""
    n = (1 << 16) + 3
    sk = rng.integers(0, 1 << 20, n).astype(np.int32)
    tk = rng.integers(0, 1 << 20, 2 * n).astype(np.int32)
    args = (sk, np.arange(n, dtype=np.int32), tk,
            np.arange(2 * n, dtype=np.int32))
    kw = dict(algorithm="broadcast", small_side="s", t_machines=2)
    want, want_rep = jcluster.join(*args, **kw)
    got, rep = cluster.join(*args, **kw, device="cpu")
    for field in ("s_rows", "t_rows", "valid", "count", "dropped"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert int(got.count.sum()) > 0 and int(got.dropped.max()) == 0
    np.testing.assert_array_equal(rep.workload, want_rep.workload)


# ---------------------------------------------------------------------------
# host dtypes at the front door
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_front_door_narrows_float64_like_the_reference(algorithm):
    """float64 keys and int64 values come back float32 and int32, equal
    to the reference's (jnp.asarray narrows them with x64 off)."""
    t, m, seed = 4, 192, 2
    x = uniform_keys(t * m, seed=5).reshape(t, m).astype(np.float64) * 3.1
    v = np.arange(t * m, dtype=np.int64).reshape(t, m)
    (wk, wv), want = jcluster.sort(x, algorithm=algorithm, values=v,
                                   seed=seed)
    extra = ({"uniforms": reference_uniforms(seed, t, m)}
             if algorithm == "terasort" else {})
    (gk, gv), rep = cluster.sort(x, algorithm=algorithm, values=v,
                                 seed=seed, device="cpu", **extra)
    assert np.asarray(wk).dtype == np.float32 and gk.dtype == torch.float32
    assert gv.dtype == torch.int32 == torch.from_numpy(np.asarray(wv)).dtype
    assert_bitwise(gk, wk)
    assert_bitwise(gv, wv)
    assert_reports_equal(rep, want)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_join_takes_int64_and_float64_host_arrays_like_the_reference(
        rng, dtype):
    sk = rng.integers(0, 40, 300).astype(dtype)
    tk = rng.integers(0, 40, 500).astype(dtype)
    args = (sk, np.arange(300, dtype=dtype), tk, np.arange(500, dtype=dtype))
    for algorithm in ("statjoin", "broadcast"):
        want, _ = jcluster.join(*args, algorithm=algorithm, t_machines=4)
        got, _ = cluster.join(*args, algorithm=algorithm, t_machines=4,
                              device="cpu")
        for field in ("s_rows", "t_rows", "valid", "count"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))


# ---------------------------------------------------------------------------
# On the card: each bf16 kernel and the wide rows against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


def _same(a, b):
    assert_bitwise(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 4096, 65536])
def test_cuda_bf16_sorts_equal_plain(card, rng, n):
    _, xt = bf16(edge_keys(rng, (4, n)))
    iota = torch.arange(n, dtype=torch.int32).repeat(4, 1)
    _same(bitonic.bitonic_sort(xt.to(card)), bitonic.bitonic_sort_plain(xt))
    for g, w in zip(bitonic.bitonic_sort_kv(xt.to(card), iota.to(card)),
                    bitonic.bitonic_sort_kv_plain(xt, iota)):
        _same(g, w)
    from repro_torch.kernels import radix
    for g, w in zip(radix.radix_sort(xt.to(card)), radix.radix_sort_plain(xt)):
        _same(g, w)
    qs = sorted_bf16_rows(rng, (1, 7))[0].expand(4, -1).contiguous()
    for g, w in zip(fused.sort_partition_kv(xt.to(card), qs.to(card)),
                    fused.sort_partition_kv_plain(xt, qs)):
        _same(g, w)
    for g, w in zip(fused.sort_partition(xt.to(card), qs.to(card)),
                    fused.sort_partition_plain(xt, qs)):
        _same(g, w)


@pytest.mark.cuda
def test_cuda_bf16_searches_and_merges_equal_plain(card, rng):
    rows = sorted_bf16_rows(rng, (8, 1077))
    _same(bitonic.merge_sorted_rows(rows.to(card)),
          bitonic.merge_sorted_rows_plain(rows))
    for g, w in zip(bitonic.merge_sorted_rows_argsort(rows.to(card)),
                    bitonic.merge_sorted_rows_argsort_plain(rows)):
        _same(g, w)
    q = sorted_bf16_rows(rng, (8, 63))
    for side in ("left", "right"):
        _same(bucketize.searchsorted(rows.to(card), q.to(card), side),
              bucketize.searchsorted_plain(rows, q, side))
    _, kt = bf16(edge_keys(rng, (300_001,)))
    for g, w in zip(bucketize.bucketize_histogram(kt.to(card),
                                                  q[0].to(card), 64),
                    bucketize.bucketize_histogram_plain(kt, q[0], 64)):
        _same(g, w)
    kp = bitonic._pad_sorted_rows(rows, np.inf)[None]
    ip = bitonic._pad_iota_unique(8, 1077, *kp.shape[1:])[None]
    for bb in (None, 256):
        _same(fused.merge_ranks(kp.to(card), ip.to(card), bb),
              fused.merge_ranks_plain(kp, ip, bb))


@pytest.mark.cuda
def test_cuda_wide_rows_and_many_rows_equal_plain(card, rng):
    """A sort of rows of 2^18 (radix), the search over them, and a rank
    merge of 600 rows (t > 512) on the card against the plain versions."""
    x = torch.from_numpy(edge_keys(rng, (2, 1 << 18)))
    x[torch.isinf(x)] = 0.0
    cuda.reset_launches()
    got = ops.sort(x.to(card))
    assert cuda.LAUNCHES["radix_sort"] == 1
    _same(got, ops.sort(x))
    q = torch.sort(x[:, :63], dim=-1).values.contiguous()
    _same(ops.searchsorted(got, q.to(card)), ops.searchsorted(ops.sort(x), q))
    rows = torch.sort(torch.from_numpy(edge_keys(rng, (600, 130))),
                      dim=-1).values
    rows[torch.isinf(rows)] = 0.0
    rows = torch.sort(rows, dim=-1).values
    _same(ops.merge_sorted_rows(rows.to(card)), ops.merge_sorted_rows(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_cuda_cluster_sort_bf16_equals_cpu(card, algorithm):
    t, m = 8, 4096
    _, xt = bf16(uniform_keys(t * m, seed=4).reshape(t, m))
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    u = torch.rand((t, m), generator=torch.Generator().manual_seed(4))
    extra = {"uniforms": u} if algorithm == "terasort" else {}
    (gk, gv), rep = cluster.sort(xt, algorithm=algorithm, values=v, **extra)
    (wk, wv), want = cluster.sort(xt, algorithm=algorithm, values=v,
                                  device="cpu", **extra)
    _same(gk, wk)
    _same(gv, wv)
    assert_reports_equal(rep, want)
