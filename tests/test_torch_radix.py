"""The port's radix sort family against the reference's, on the CPU.

The same seeded numpy keys go through ``repro.kernels.radix`` (the
Pallas kernel in interpret mode) and ``repro_torch.kernels.radix``
(its plain PyTorch version); the ops under each package's forced radix
family; and the cluster front door, SMMS and Terasort with and without
values, under forced radix on both sides.  Every comparison is bitwise,
floats on their bit views, so NaN != NaN cannot pass a row vacuously.
Tests marked ``cuda`` hold the CUDA kernel against its plain version on
the card and skip where there is none.  Keys are int32, float32 and
bf16, the reference's own dtypes (tests/test_radix.py:91); bf16 keys
are 16-bit keys, sorted in 4 passes.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro.kernels import ops as jops
from repro.kernels import radix as jradix
from repro_torch import cluster
from repro_torch.core import report_fields
from repro_torch.data import lidar_like, uniform_keys
from repro_torch.kernels import cuda, ops, radix

from test_radix import N_CASES, adversarial_keys
from test_torch_terasort import assert_reports_equal, reference_uniforms

DTYPES = {"int32": np.int32, "float32": np.float32,
          "bfloat16": jnp.bfloat16}


def tt(x: np.ndarray) -> torch.Tensor:
    """A torch tensor of numpy keys, bf16 (ml_dtypes) by its bits."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def keys(dtype: str, case: int, rows: int, n: int) -> np.ndarray:
    return np.stack([adversarial_keys(DTYPES[dtype], case, n,
                                      seed=case * 31 + r)
                     for r in range(rows)])


# ---------------------------------------------------------------------------
# the key bijection and the comparator's classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(N_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_key_bits_match_reference_and_round_trip(dtype, case):
    x = keys(dtype, case, 2, 300)
    got = radix.key_to_bits(tt(x))
    assert got.dtype == torch.int32
    want = jradix.key_to_bits(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    back = radix.bits_to_key(got, tt(x).dtype)
    assert_bitwise(back, x)
    want_back = jradix.bits_to_key(jradix.key_to_bits(jnp.asarray(x)),
                                   jnp.asarray(x).dtype)
    assert_bitwise(back, want_back)


@pytest.mark.parametrize("case", range(N_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_ready_bits_match_reference(dtype, case):
    x = keys(dtype, case, 2, 300)
    got = radix.sort_ready_bits(tt(x))
    want = jradix._sort_ready_bits(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_every_float_class_folds_as_the_reference_folds():
    """NaN payloads of both signs, +-0, denormals of both signs, +-inf,
    the band's edges (the smallest normals stay apart)."""
    pats = np.uint32([0x7fc00000, 0xffc00000, 0x7f800001, 0xffffffff,
                      0x00000000, 0x80000000, 0x00000001, 0x807fffff,
                      0x007fffff, 0x80000001, 0x00800000, 0x80800000,
                      0x7f800000, 0xff800000, 0x3f800000, 0xbf800000])
    x = pats.view(np.float32)[None]
    got = radix.sort_ready_bits(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(jradix._sort_ready_bits(jnp.asarray(x)))
        .view(np.uint32))
    assert (got[0, :4] == 0xffffffff).all()          # every NaN last
    assert (got[0, 4:10] == 0x80000000).all()        # zeros and denormals
    assert got[0, 10] == 0x80800000 and got[0, 11] == 0x7f7fffff


# ---------------------------------------------------------------------------
# radix_sort (plain version) against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(1, 7), (3, 100), (4, 257), (2, 1024)])
@pytest.mark.parametrize("case", range(N_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_radix_sort_plain_matches_reference(dtype, case, rows, n):
    x = keys(dtype, case, rows, n)
    got, order = radix.radix_sort(tt(x))
    want, want_order = jradix.radix_sort(jnp.asarray(x))
    assert order.dtype == torch.int32
    assert_bitwise(got, want)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    # and the stable argsort of the canonical bits, independently
    canon = radix.sort_ready_bits(tt(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(canon, axis=1, kind="stable"))


def test_pass_positions_are_a_stable_counting_pass():
    b = torch.tensor([[0x13, 0x02, 0x21, 0x03, 0x11, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        radix.pass_positions_plain(b, 0).numpy(), [[3, 2, 0, 4, 1, 5]])
    # shift 28 of a negative carrier: the sign fill is masked off
    np.testing.assert_array_equal(
        radix.pass_positions_plain(b, 28).numpy(), [[0, 1, 2, 3, 4, 5]])


def test_radix_sort_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="rows, n"):
        radix.radix_sort(torch.zeros(8))
    with pytest.raises(TypeError, match="radix key"):
        radix.radix_sort(torch.zeros(2, 8, dtype=torch.float64))
    got, order = radix.radix_sort(torch.zeros(3, 0))
    assert got.shape == order.shape == (3, 0)


# ---------------------------------------------------------------------------
# the ops under forced radix, against the reference's ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["sort", "sort_kv", "sort_partition",
                                "sort_partition_kv"])
def test_ops_forced_radix_match_reference(op, dtype):
    """Each op on (3, 300) rows against the reference's 1-D op on each
    row, both under their forced radix family."""
    x = np.concatenate([keys(dtype, c, 1, 300) for c in (1, 5, 6)])
    if op.startswith("sort_partition") and dtype != "int32":
        x[np.isnan(x)] = 7.0              # the queries need an order
    q = np.sort(x[0, [3, 50, 99, 201]])
    tx, tq = tt(x), tt(q)
    tv = torch.arange(300, dtype=torch.int32).repeat(3, 1)
    ops.reset_dispatch_counts()
    with ops.force_sort_kernel("radix"):
        got = {"sort": lambda: (ops.sort(tx),),
               "sort_kv": lambda: ops.sort_kv(tx, tv),
               "sort_partition": lambda: ops.sort_partition(tx, tq),
               "sort_partition_kv": lambda: ops.sort_partition_kv(tx, tv, tq),
               }[op]()
    iota, jq = jnp.arange(300), jnp.asarray(q)
    want_fn = {"sort": lambda r: (jops.sort(r, backend="pallas"),),
               "sort_kv": lambda r: jops.sort_kv(r, iota, backend="pallas"),
               "sort_partition": lambda r: jops.sort_partition(
                   r, jq, backend="pallas"),
               "sort_partition_kv": lambda r: jops.sort_partition_kv(
                   r, iota, jq, backend="pallas")}[op]
    jops.reset_dispatch_counts()
    with jops.force_sort_kernel("radix"):
        want = [want_fn(jnp.asarray(r)) for r in x]
    assert any(path == "radix" for _, path in jops.DISPATCH_COUNTS)
    for i, w in enumerate(want):
        assert len(got) == len(w)
        for g, wi in zip(got, w):
            assert_bitwise(g[i], wi)
    sort_op = "sort_kv" if op.endswith("kv") else "sort"
    assert dict(ops.DISPATCH_COUNTS).get((sort_op, "radix-plain")) == 1
    assert not any(path in ("cuda", "radix-cuda")
                   for _, path in ops.DISPATCH_COUNTS)
    if op.startswith("sort_partition"):
        # no fused radix+search: a sort, then the search kernel
        assert ops.DISPATCH_COUNTS[("searchsorted", "plain")] == 1
        assert (op, "plain") not in ops.DISPATCH_COUNTS


@pytest.mark.parametrize("dtype", DTYPES)
def test_prepadded_radix_keeps_the_sentinel_tail_last(dtype):
    """SMMS pads once and sorts prepadded: under radix the sentinel pads
    land after every real key equal to the sentinel, in position order,
    as the bitonic pair sort places them."""
    m = 37
    big = np.iinfo(np.int32).max if dtype == "int32" else np.inf
    x = np.random.default_rng(3).integers(-4, 4, (3, m)).astype(DTYPES[dtype])
    x[:, ::5] = big
    kp = ops.pad_pow2(tt(x))
    vp = ops.pad_pow2(torch.arange(3 * m, dtype=torch.int32).reshape(3, m),
                      fill=0, axis=1)
    with ops.force_sort_kernel("radix"):
        rk, rv = ops.sort_kv(kp, vp, prepadded=True)
        rs = ops.sort(kp, prepadded=True)
    with ops.force_sort_kernel("bitonic"):
        bk, bv = ops.sort_kv(kp, vp, prepadded=True)
    assert_bitwise(rk, bk)
    assert_bitwise(rs, bk)
    np.testing.assert_array_equal(rv.numpy(), bv.numpy())
    np.testing.assert_array_equal(rv[:, m:].numpy(), 0)      # the pads last
    np.testing.assert_array_equal(
        rv[:, :m].numpy(),
        np.argsort(x, axis=1, kind="stable") + np.arange(3)[:, None] * m)


# ---------------------------------------------------------------------------
# the family choice
# ---------------------------------------------------------------------------

def _on_card(shape, dtype=torch.float32):
    """A stand-in for a CUDA tensor: the choice reads device, shape and
    dtype only, so the card's branch is testable without a card."""
    return types.SimpleNamespace(is_cuda=True, shape=shape, dtype=dtype)


def test_sort_kernel_choice_pins_bitonic_on_the_cpu_and_forcing_wins():
    wide = torch.zeros(64, 1 << 16)
    assert ops.sort_kernel_choice(wide) == "bitonic"
    with ops.force_sort_kernel("radix"):
        assert ops.sort_kernel_choice(wide) == "radix"
        assert ops.sort_kernel_choice(torch.zeros(2, 3)) == "radix"
        with ops.force_sort_kernel(None):
            assert ops.sort_kernel_choice(wide) == "bitonic"
        with ops.force_sort_kernel("bitonic"):
            assert ops.sort_kernel_choice(_on_card((64, 1 << 16))) == \
                "bitonic"
        assert ops.sort_kernel_choice(wide) == "radix"
    assert ops.sort_kernel_choice(wide) == "bitonic"
    with pytest.raises(ValueError, match="unknown sort kernel family"):
        with ops.force_sort_kernel("quantum"):
            pass
    assert ops.sort_kernel_choice(wide) == "bitonic"


def test_sort_kernel_choice_on_the_card_is_the_fitted_cost_model():
    """The reference's formula with the constants fitted on the H100:
    radix at exactly the widths where it measured faster (PERF.md)."""
    def choice(n, dtype=torch.float32):
        return ops.sort_kernel_choice(_on_card((64, n), dtype))

    for n in (1, 1000, 1 << 12, ops.RADIX_MIN_LANES - 1):
        assert choice(n) == "bitonic"
    for k in range(10, 17):
        n = 1 << k
        logn = k
        want = ("radix" if n >= ops.RADIX_MIN_LANES and logn * (logn + 1) // 2
                > 8 * ops.RADIX_PASS_SUBSTAGES else "bitonic")
        assert choice(n) == choice(n, torch.int32) == want
        assert choice(n) == ("radix" if n in FITTED_RADIX_WIDTHS
                             else "bitonic")
        # bf16 keys take 4 passes, so the model crosses for them first
        want16 = ("radix" if n >= ops.RADIX_MIN_LANES and logn * (logn + 1)
                  // 2 > 4 * ops.RADIX_PASS_SUBSTAGES else "bitonic")
        assert choice(n, torch.bfloat16) == want16
        assert want16 == ("radix" if n in FITTED_RADIX_WIDTHS_BF16
                          else "bitonic")
    assert choice(1 << 16, torch.float64) == "bitonic"
    # the formula crosses at 2^15 for bf16 keys (4 passes), past the
    # bitonic tile's reach for 32-bit ones (8 passes)
    assert 15 * 16 // 2 > 4 * ops.RADIX_PASS_SUBSTAGES >= 14 * 15 // 2
    assert 8 * ops.RADIX_PASS_SUBSTAGES >= 16 * 17 // 2
    # past the reach (C10) every row sorts by radix, on either device,
    # whatever is forced
    for n in (65537, 1 << 17):
        assert choice(n) == choice(n, torch.int32) == "radix"
        assert ops.sort_kernel_choice(torch.zeros(2, n)) == "radix"
        with ops.force_sort_kernel("bitonic"):
            assert choice(n, torch.bfloat16) == "radix"
    assert ops.kernel_eligible("radix", torch.zeros(4, 65535))
    assert ops.kernel_eligible("radix", torch.zeros(4, 65537))
    assert ops.kernel_eligible("radix", torch.zeros(4, 8, dtype=torch.bfloat16))
    assert not ops.kernel_eligible("radix", torch.zeros(4, 8, 2))
    assert not ops.kernel_eligible("radix", torch.zeros(4, 8,
                                                        dtype=torch.float64))


# The widths (64, 2^k), k = 10..16, at which the radix kernel (the 8-bit
# onesweep) measured faster than the bitonic one on keys only, on the
# card (PERF.md, the crossover table), float32 and bf16: none in
# float32, 2^15 and 2^16 in bf16.
FITTED_RADIX_WIDTHS = ()
FITTED_RADIX_WIDTHS_BF16 = (1 << 15, 1 << 16)


# ---------------------------------------------------------------------------
# the front door under forced radix, against the reference's
# ---------------------------------------------------------------------------

def _reference_sort(x, algorithm, v, seed):
    with jops.force_sort_kernel("radix"):
        return jcluster.sort(x, algorithm=algorithm, values=v, seed=seed,
                             kernel_backend="pallas")


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
@pytest.mark.parametrize("t,m", [(4, 512), (8, 1024)])
def test_cluster_sort_forced_radix_matches_reference(t, m, algorithm,
                                                     with_values):
    gen = uniform_keys if algorithm == "smms" else lidar_like
    x = gen(t * m, seed=t + m).reshape(t, m)
    v = (np.random.default_rng(t).integers(0, 1 << 30, (t, m, 3))
         .astype(np.int32) if with_values else None)
    seed = t + 1
    jops.reset_dispatch_counts()
    (wk, wv), want = _reference_sort(x, algorithm, v, seed)
    assert any(path == "radix" for _, path in jops.DISPATCH_COUNTS)
    extra = ({"uniforms": reference_uniforms(seed, t, m)}
             if algorithm == "terasort" else {})
    ops.reset_dispatch_counts()
    with ops.force_sort_kernel("radix"):
        (gk, gv), rep = cluster.sort(x, algorithm=algorithm, values=v,
                                     seed=seed, device="cpu", **extra)
    assert_bitwise(gk, wk)
    np.testing.assert_array_equal(gk.numpy(), np.sort(x.reshape(-1)))
    if with_values:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    else:
        assert gv is None and wv is None
    assert_reports_equal(rep, want)
    assert report_fields(rep)["alpha"] == 3
    sort_op = "sort_kv" if with_values else "sort"
    assert ops.DISPATCH_COUNTS[(sort_op, "radix-plain")] == 1
    assert ops.DISPATCH_COUNTS[("searchsorted", "plain")] == 1
    assert not any(op.startswith("sort_partition")
                   for op, _ in ops.DISPATCH_COUNTS)


def test_cluster_sort_forced_radix_equals_bitonic_with_ties():
    """Zipf-like ties through the payload path: the two families give the
    same keys and the same stable order of the values."""
    t, m = 4, 1024
    x = np.random.default_rng(9).integers(0, 37, (t, m)).astype(np.float32)
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    out = {}
    for family in ops.SORT_FAMILIES:
        with ops.force_sort_kernel(family):
            out[family] = [cluster.sort(x, algorithm=a, values=v, seed=2,
                                        device="cpu")[0]
                           for a in ("smms", "terasort")]
    for (rk, rv), (bk, bv) in zip(out["radix"], out["bitonic"]):
        assert_bitwise(rk, bk)
        np.testing.assert_array_equal(rv.numpy(), bv.numpy())
        np.testing.assert_array_equal(
            rv.numpy(), np.argsort(x.reshape(-1), kind="stable"))


def test_radix_kernel_is_not_built_on_the_cpu():
    cuda.reset_launches()
    with ops.force_sort_kernel("radix"):
        ops.sort(torch.zeros(2, 50))
    assert not cuda.LAUNCHES


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 257, 4097, 65535, 65536])
def test_cuda_radix_sort_equals_plain(card, dtype, n):
    x = tt(np.concatenate([keys(dtype, c, 1, n) for c in range(N_CASES)]))
    got, order = radix.radix_sort(x.to(card))
    want, want_order = radix.radix_sort_plain(x)
    assert got.is_cuda and order.is_cuda
    assert_bitwise(got, want)
    np.testing.assert_array_equal(order.cpu().numpy(), want_order.numpy())


@pytest.mark.cuda
def test_cuda_forced_radix_launches_the_kernel_or_raises(card):
    x = torch.rand(4, 5000, device=card)
    cuda.reset_launches()
    with ops.force_sort_kernel("radix"):
        ops.sort(x)
        ops.sort_kv(x, torch.zeros(4, 5000, 2, device=card))
        ops.sort_partition(x, torch.tensor([0.5], device=card))
        with pytest.raises(TypeError):
            radix.radix_sort(x.double())
    assert cuda.LAUNCHES["radix_sort"] == 3
    assert not any(k.startswith("bitonic") or k.startswith("sort_partition")
                   for k in cuda.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
def test_cuda_cluster_sort_forced_radix_equals_cpu(card, algorithm):
    t, m = 8, 4096
    x = uniform_keys(t * m, seed=5).reshape(t, m)
    v = np.random.default_rng(5).integers(0, 1 << 30, (t, m, 2)) \
        .astype(np.int32)
    u = torch.rand((t, m), generator=torch.Generator().manual_seed(5))
    extra = {"uniforms": u} if algorithm == "terasort" else {}
    with ops.force_sort_kernel("radix"):
        (gk, gv), rep = cluster.sort(x, algorithm=algorithm, values=v, **extra)
        (wk, wv), want = cluster.sort(x, algorithm=algorithm, values=v,
                                      device="cpu", **extra)
    assert gk.is_cuda and gv.is_cuda
    assert_bitwise(gk, wk)
    np.testing.assert_array_equal(gv.cpu().numpy(), wv.numpy())
    assert_reports_equal(rep, want)
