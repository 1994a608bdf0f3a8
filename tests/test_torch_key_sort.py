"""The keys-only sorts' one-launch schedule (``csrc/sort_tiles.cuh:row_keys``).

The CUDA keys-only sort (``bitonic.bitonic_sort``) and fused sort and
search (``fused.sort_partition``) run the pair sorts' schedule
(``tests/test_torch_pair_sort.py`` models its rounds, groups, swizzled
layout and directions) on keys alone, under the keys-only swap rule:
two keys swap only when ``gt(a, b)`` differs from the direction, so keys
that compare equal but differ in bits (+0/-0, the denormals C1 folds to
zero, NaN) never trade places, and where they end up is the network's.
The kernel's words, modelled here in torch against the reference
network's plain version (``bitonic.sort_network_block``), bitwise:

* a row with no NaN key and no key that folds: the 32-bit key integer
  (``RowKey::to``; bf16 its key integer over its 16 bits), compared
  whole;
* a row whose keys fold: the key integer over the key's own bits (a
  32-bit word for bf16, a 64-bit one for float32), compared on the key
  half only -- and the trap beside it: the whole (key, column) word
  gives the stable order, which is not the network's;
* a row with a NaN key: the keys as they are.

Then the fused search: the plain version against the reference's Pallas
kernel in interpret mode on NaN rows past one 8,192-slot tile, and the
per-tile count the split schedule summed before (C12) against it.  On
the card (``cuda`` marker): both kernels against their plain versions
on unsorted NaN rows, rows of +-0 and denormals only, and gaussian rows
at widths 3 to 65,536 and past a cluster's reach, and one kernel a
call.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import fused as jfused
from repro_torch.kernels import bitonic, fused
from test_torch_pair_sort import (LOG_SLICE, directions, from_unsigned,
                                  group_bases, key_bits, layout,
                                  profiled_kernels, round_bits, rounds, swz,
                                  to_unsigned)
# autouse: this module's models run on one torch thread too
from test_torch_pair_sort import one_torch_thread  # noqa: F401

INT32_MAX = np.iinfo(np.int32).max
# the layouts of the pair sorts' tests: one CTA (n <= slice) and clusters
# of 2-8 CTAs (slices of 2^11-2^13)
LAYOUTS = [(3, 13), (9, 13), (13, 11), (14, 13), (16, 13)]
_LOW = {torch.float32: 0xFFFFFFFF, torch.bfloat16: 0xFFFF}
_SHIFT = {torch.float32: 32, torch.bfloat16: 16}


def words(keys: torch.Tensor, rep: str):
    """The kernel's slot of each key and the slot's bytes in shared
    memory: ``key`` the key integer alone (4 bytes); ``bits`` and
    ``half`` the key integer over the key's bits (4 bytes for bf16, 8 for
    float32); ``pair`` the key integer over the key's column (the trap;
    4 bytes for bf16, 8 for float32).  As int64, the key integer biased
    by half its range so that a 64-bit word's order is its signed order."""
    t = to_unsigned(keys)
    if rep == "key":
        return t, 4
    shift = _SHIFT[keys.dtype]
    low = (key_bits(keys).long() & _LOW[keys.dtype] if rep != "pair" else
           torch.arange(keys.shape[1]).expand_as(t))
    return ((t - (1 << (shift - 1))) << shift) | low, shift // 4


def model_sort_keys(keys: torch.Tensor, rep: str,
                    log_slice: int = LOG_SLICE) -> torch.Tensor:
    """The kernel's schedule on (rows, n) keys alone, n a power of two:
    every slot in its CTA's swizzled shared memory; each round gathers its
    groups of slots, runs its substages on them in the direction of the
    kernel's mask and scatters them back.  ``rep``: ``exact`` (the keys,
    swapped on the folded comparison), or the words of :func:`words`,
    swapped on the whole word (``key``, ``bits``, ``pair``) or on the
    key half (``half``).  Returns the sorted keys as the kernel writes
    them: decoded from the key integer (``key``), the low bits (``bits``,
    ``half``), or the caller's row at the column (``pair``)."""
    rows, n = keys.shape
    log_total = n.bit_length() - 1
    log_l, log_c = layout(log_total, log_slice)
    ll = 1 << log_l
    pos = torch.arange(n)
    if rep == "exact":
        sk, nbytes = key_bits(keys), keys.element_size()

        def after(a, b):
            return bitonic.ftz(a.view(keys.dtype)) > bitonic.ftz(
                b.view(keys.dtype))
    else:
        sk, nbytes = words(keys, rep)
        shift = 0 if rep == "key" else _SHIFT[keys.dtype]

        def after(a, b):
            return (a >> shift) > (b >> shift) if rep == "half" else a > b

    def where(p):                       # row position -> shared memory
        return (p >> log_l) * ll + swz(p & (ll - 1), nbytes,
                                       round_bits(log_l))

    tile = torch.empty_like(sk)
    tile[:, where(pos)] = sk
    w = min(round_bits(log_l), log_l)
    for remote, e, k, j_lo, j_hi in rounds(log_total, log_l):
        base = group_bases(remote, e, w, log_l, log_c).reshape(-1)
        u = torch.arange(1 << w)
        p = base[:, None] | (u[None, :] << e)              # (groups, 2^w)
        g = tile[:, where(p)]                              # (rows, G, 2^w)
        steps = ([(kk, j) for kk in k for j in range(kk, -1, -1)]
                 if isinstance(k, range)
                 else [(k, j) for j in range(j_hi, j_lo - 1, -1)])
        for kk, j in steps:
            bit = 1 << (j - e)
            lo = u[(u & bit) == 0]
            hi = lo | bit
            desc = ((directions(base, e, kk)[:, None] >> lo[None, :]) & 1) == 1
            a, b = g[:, :, lo], g[:, :, hi]
            swap = after(a, b) != desc[None]
            g = g.clone()
            g[:, :, lo] = torch.where(swap, b, a)
            g[:, :, hi] = torch.where(swap, a, b)
        tile[:, where(p)] = g
    out = tile[:, where(pos)]
    if rep == "exact":
        return out.view(keys.dtype)
    if rep == "key":
        return from_unsigned(out, keys.dtype, keys, torch.zeros_like(out))
    low = out & _LOW[keys.dtype]
    if rep == "pair":
        return key_bits(keys).gather(1, low).view(keys.dtype)
    bits_dtype = torch.int32 if keys.dtype == torch.float32 else torch.int16
    half = _LOW[keys.dtype] // 2 + 1
    return torch.where(low >= half, low - 2 * half, low).to(
        bits_dtype).view(keys.dtype)


def plain_keys(rng, rows, n, dtype, kind):
    """Rows of n keys: ``plain`` (gaussian floats, int32 from a wide
    domain with ties and INT32_MAX; no NaN, no key that folds), ``folds``
    (+-0 and denormals among gaussian keys and +-inf, one row of +-0 and
    denormals only), ``nan`` (gaussian keys, five NaNs a row at random
    places, a negative NaN and a NaN with a payload among them)."""
    if dtype == torch.int32:
        k = rng.integers(-2**31, 2**31 - 1, (rows, n), dtype=np.int64)
        k[:, ::3] = rng.integers(-4, 4, (rows, (n + 2) // 3))
        k[:, ::7] = INT32_MAX
        return torch.from_numpy(k.astype(np.int32))
    x = rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "folds":
        tiny = np.float32([0.0, -0.0, 1e-40, -1e-40, 2e-39, -3e-39, 5e-41])
        x[:, ::2] = rng.choice(tiny, size=x[:, ::2].shape)
        x[:, 1::5] = rng.choice(np.float32([np.inf, -np.inf, 1.5]),
                                size=x[:, 1::5].shape)
        x[0] = rng.choice(tiny, size=n)
    elif kind == "nan":
        for r in range(rows):
            x[r, rng.permutation(n)[:min(n, 5)]] = np.nan
        flat = x.reshape(-1).view(np.uint32)
        nans = np.flatnonzero(np.isnan(x.reshape(-1)))
        flat[nans[::2]] = 0xFFC00000                   # a negative NaN
        flat[nans[1::3]] = 0x7FC00123                  # a payload
    t = torch.from_numpy(x)
    if dtype == torch.bfloat16:
        # bf16 bits from the float32 bits (top half): NaN payloads kept
        t = (t.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)
    if kind != "nan":
        t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
    return t


def _padded(keys: torch.Tensor, real: int) -> torch.Tensor:
    """The last n - real slots set to the sort sentinel, as loaded."""
    n = keys.shape[1]
    pad = torch.arange(n) >= real
    return torch.where(pad, torch.tensor(bitonic.sort_sentinel(keys.dtype),
                                         dtype=keys.dtype), keys)


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype
    assert torch.equal(key_bits(got), key_bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("log_n, log_slice", LAYOUTS)
def test_whole_words_equal_the_network(rng, dtype, log_n, log_slice):
    """A row with no NaN key and no key that folds, sorted as 32-bit words
    compared whole -- the key integer (float32, int32), for bf16 the key
    integer over its bits -- equals the network bitwise (three pads)."""
    keys = _padded(plain_keys(rng, 2, 1 << log_n, dtype, "plain"),
                   (1 << log_n) - 3)
    rep = "bits" if dtype == torch.bfloat16 else "key"
    if dtype == torch.bfloat16:
        assert words(keys, rep)[1] == 4
    assert_same_bits(model_sort_keys(keys, rep, log_slice),
                     bitonic.sort_network_block(keys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("log_n, log_slice", LAYOUTS)
def test_key_half_words_equal_the_network(rng, dtype, log_n, log_slice):
    """Rows full of +0, -0 and denormals: the key integer over the key's
    bits (32-bit for bf16, 64-bit for float32), compared on the key half
    only, equals the network bitwise, the zero class's order included."""
    keys = _padded(plain_keys(rng, 2, 1 << log_n, dtype, "folds"),
                   (1 << log_n) - 3)
    assert_same_bits(model_sort_keys(keys, "half", log_slice),
                     bitonic.sort_network_block(keys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("log_n, log_slice", [(9, 13), (14, 13)])
def test_whole_words_on_folding_keys_are_not_the_network(rng, dtype, log_n,
                                                         log_slice):
    """The trap: on a row of +-0 and denormals the whole (key, column)
    word sorts stably -- each class of equal keys in column order, what a
    stable sort gives -- and that is not the network's order, which the
    key-half compare keeps."""
    keys = plain_keys(rng, 2, 1 << log_n, dtype, "folds")
    want = bitonic.sort_network_block(keys)
    trap = model_sort_keys(keys, "pair", log_slice)
    order = torch.sort(bitonic.ftz(keys).float(), dim=1, stable=True).indices
    assert torch.equal(key_bits(trap), key_bits(keys).gather(1, order))
    assert not torch.equal(key_bits(trap), key_bits(want))
    assert_same_bits(model_sort_keys(keys, "half", log_slice), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("log_n, log_slice", [(3, 13), (13, 11), (16, 13)])
def test_exact_slots_on_nan_rows_equal_the_network(rng, dtype, log_n,
                                                   log_slice):
    """A row with NaN keys runs the keys as they are: the rounds give the
    network's output bitwise, each NaN where the swap rule leaves it."""
    keys = plain_keys(rng, 2, 1 << log_n, dtype, "nan")
    got = model_sort_keys(keys, "exact", log_slice)
    want = bitonic.sort_network_block(keys)
    assert_same_bits(got, want)
    if log_n >= 13:                     # NaN left inside the row, not last
        assert bool(torch.isnan(want[:, :-5]).any())


def _nan_partition_operands(rng, rows, m, dtype=torch.float32):
    """Unsorted NaN rows of m keys and 63 ascending queries drawn from the
    first row, a NaN query among them."""
    keys = plain_keys(rng, rows, m, dtype, "nan")
    q = keys[0, rng.permutation(m)[:62]]
    q = torch.sort(q[~torch.isnan(q)]).values[None]
    nan = torch.full((1, 1), float("nan"), dtype=dtype)
    q = torch.cat([q[:, :31], nan, q[:, 31:]], dim=1)
    return keys, q.expand(rows, -1).contiguous()


@pytest.mark.parametrize("m", [9000, 20000])
def test_plain_sort_partition_equals_reference_on_nan_rows(rng, m):
    """Past one 8,192-slot tile, unsorted NaN rows: the plain version's
    keys and cuts are the reference's Pallas kernel's (interpret mode),
    NaN query included (the reference flushes its denormal outputs, C1;
    these rows hold none)."""
    keys, q = _nan_partition_operands(rng, 2, m)
    xs, cuts = fused.sort_partition_plain(keys, q)
    for r in range(2):
        wxs, wcuts = jfused.sort_partition(jnp.asarray(keys[r].numpy()),
                                           jnp.asarray(q[r].numpy()))
        np.testing.assert_array_equal(xs[r].numpy().view(np.int32),
                                      np.asarray(wxs).view(np.int32))
        np.testing.assert_array_equal(cuts[r].numpy(), np.asarray(wcuts))


def _lower_bound(part: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The split schedule's per-tile search, one query a thread: ``lo,
    hi = 0, len; while lo < hi: mid = (lo + hi) >> 1; lo = mid + 1 if
    part[mid] < key else lo; hi = hi if part[mid] < key else mid``, on
    the folded keys, every query of a row at once."""
    fp, fq = bitonic.ftz(part), bitonic.ftz(q)
    lo = torch.zeros(q.shape, dtype=torch.long)
    hi = torch.full(q.shape, part.shape[1], dtype=torch.long)
    for _ in range(part.shape[1].bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = fp.gather(1, mid.clamp_max(part.shape[1] - 1)) < fq
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo.to(torch.int32)


@pytest.mark.parametrize("kind", ["nan", "plain"])
def test_per_tile_counts_miss_the_search_on_nan_rows(rng, kind):
    """C12: the split schedule's fused search summed each 8,192-slot
    tile's lower bound of a query.  On a sorted row that is the
    reference's cut; on a row past one tile with NaN keys, which the
    network leaves inside the row, it is not, and only the reference's
    own fixed-step search over the row (what row_finish runs) gives it."""
    rows, m, tile = 8, 20000, 1 << 13
    keys, q = _nan_partition_operands(rng, rows, m)
    if kind == "plain":
        keys = torch.where(torch.isnan(keys), torch.zeros_like(keys), keys)
    xs, cuts = fused.sort_partition_plain(keys, q)
    n = bitonic._next_pow2(m)
    padded = bitonic.sort_network_block(bitonic._pad_row(keys))
    summed = torch.zeros_like(cuts)
    for t0 in range(0, m, tile):
        summed += _lower_bound(padded[:, t0:min(m, t0 + tile)], q)
    assert n > tile
    if kind == "nan":
        assert not torch.equal(summed, cuts)
    else:
        assert torch.equal(summed, cuts)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_key_sort.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("m", [3, 1000, 8193, 20000, 65536, 70001])
def test_cuda_key_sorts_equal_plain(card, rng, dtype, m):
    """One CTA (3, 1,000), clusters of 2, 4 and 8 (8,193, 20,000, 65,536)
    and past a cluster's reach (70,001: the split schedule in a scratch):
    ``bitonic_sort`` and ``sort_partition`` (63 queries, a NaN among
    them) bitwise against their plain versions on unsorted NaN rows,
    rows of +-0 and denormals, and plain rows."""
    kinds = ["plain"] if dtype == torch.int32 else ["nan", "folds", "plain"]
    for kind in kinds:
        keys = plain_keys(rng, 3, m, dtype, kind)
        q = keys[0, rng.permutation(m)[:63]]
        if dtype != torch.int32:
            q[min(5, q.numel() - 1)] = float("nan")
        q = torch.sort(q).values[None].expand(3, -1).contiguous()
        assert_same_bits(bitonic.bitonic_sort(keys.to(card)).cpu(),
                         bitonic.bitonic_sort_plain(keys))
        got = fused.sort_partition(keys.to(card), q.to(card))
        want = fused.sort_partition_plain(keys, q)
        assert_same_bits(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 65536), (64, 2048)])
def test_cuda_key_sort_is_one_kernel_a_call(card, shape, dtype):
    """Under torch.profiler, 5 calls of each keys-only sort run 5 kernels
    of one name: no global pass, no fill, no copy, no padded clone."""
    for which in (0, 1):        # bitonic_sort, sort_partition
        names, c_calls = profiled_kernels("keys", which, shape, 5,
                                          str(dtype).split(".")[1])
        assert len(names) == 5 and len(set(names)) == 1, names
        assert c_calls == 5
