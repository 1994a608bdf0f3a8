"""The pair sorts' one-launch schedule (``csrc/sort_tiles.cuh:row_sort``).

The CUDA pair sort (``bitonic.bitonic_sort_kv``) and the fused pair sort
(``fused.sort_partition_kv``) run a row of up to 2^16 padded slots in one
launch: a CTA of up to 8,192 slots a row, or a cluster of 2-8 of them
whose shared memory holds the row, the network in rounds of up to five
substages on 32 slots a thread held in registers, each slot one unsigned
word when the row holds no NaN key.  The card is not here, so this file
holds

* a torch model of that schedule -- the same rounds, the same groups of
  slots, the same swizzled shared-memory layout, the same direction
  masks -- bitwise against the reference network's plain version
  (``bitonic.sort_network_block_kv``) on float32, bf16 and int32 keys
  with tied values, +-0, denormals, NaN and sentinel-valued keys, with
  the keys as they are and in the kernel's integer words;
* a mirror of the swizzles, checked exhaustively: no warp access of any
  round, load or store conflicts on a shared-memory bank; and the
  rounds the kernel separates by a warp's barrier stay in the warp;
* the plain versions at unpadded widths with the order generated
  (``values=None``) against the reference's kernels run in interpret
  mode with the iota;
* on the card (``cuda`` marker): the kernels against their plain
  versions bitwise at one CTA, clusters of 2, 4 and 8 and past a
  cluster's reach, and one kernel a call under ``torch.profiler``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bitonic as jbitonic
from repro.kernels import fused as jfused
from repro_torch.kernels import bitonic, fused

# the kernel's constants (csrc/sort_tiles.cuh)
LOG_SLICE = 13          # kRowLogSlice: slots a CTA holds
LOG_MAX_CLUSTER = 3     # kRowLogMaxCluster
ROUND = 5               # kRowLogRound: a round's group is 32 slots
INT32_MAX = np.iinfo(np.int32).max


def round_bits(log_l: int) -> int:
    """log2 of a round's group in a CTA of 2^log_l slots (row_log_round):
    32 slots in a full slice, 16 in a smaller tile."""
    return ROUND if log_l >= LOG_SLICE else 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The schedule models run thousands of small torch ops; beside other
    test processes on the same cores, each op's thread pool waits on
    threads another process holds (the file took minutes, not seconds,
    under six workers), so the module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The schedule, as the kernel runs it
# ---------------------------------------------------------------------------

def layout(log_total: int, log_slice: int = LOG_SLICE):
    """(log2 slots a CTA, log2 CTAs a row) of a padded row of 2^log_total."""
    log_l = min(log_total, log_slice)
    return log_l, log_total - log_l


def rounds(log_total: int, log_l: int):
    """The kernel's rounds in order, each ``(remote, e, k, j_lo, j_hi)``:
    the group of a round is the slots ``base | u << e``, u < 2^w (w =
    W = round_bits(log_l), or log_l for a shorter row), and the round
    runs, for each stage k in order, its substages j_hi..j_lo on the
    group.  The first round is stages 0..w-1 whole (k is a range there);
    every later stage takes one cluster round over its substages >=
    log_l - its top W, across the CTAs - then local rounds of the rest,
    W-aligned from the bottom, each in a window of the CTA's own
    slots."""
    wr = round_bits(log_l)
    w = min(wr, log_l)
    out = [(False, 0, range(w), None, None)]
    for k in range(w, log_total):
        j_hi = k
        if k >= log_l:
            out.append((True, k - wr + 1, k, k - wr + 1, k))
            j_hi = k - wr
        while j_hi >= 0:
            e = j_hi // wr * wr
            out.append((False, min(e, log_l - wr), k, e, j_hi))
            j_hi = e - 1
    return out


def swz(i, elem_bytes: int, wr: int):
    """Shared-memory index of slot i in an array of ``elem_bytes``
    elements (sort_tiles.cuh row_swz): the slot's bank bits -- five for
    4 bytes, the 4-byte word's for 2, four for 8 (a slot is two banks)
    -- XORed with the slot's bits above a round's group of 2^wr."""
    if elem_bytes == 8:
        return i ^ ((i >> wr) & 15)
    if elem_bytes == 2:
        return i ^ (((i >> wr) & 31) << 1)
    return i ^ ((i >> wr) & 31)


def threads(log_l: int) -> int:
    return max(32, (1 << log_l) >> round_bits(log_l))


def group_bases(remote: bool, e: int, w: int, log_l: int, log_c: int):
    """(CTA, thread slot g) -> row position of the group's slot u = 0, as
    the kernel computes it: a CTA's g-th group of its own slots, or (a
    cluster round) group rank * L/2^w + g of the whole row."""
    groups = (1 << log_l) >> w
    rank = torch.arange(1 << log_c)[:, None]
    g = torch.arange(groups)[None, :]
    gg = (rank << (log_l - w)) | g if remote else g
    base = ((gg >> e) << (e + w)) | (gg & ((1 << e) - 1))
    return base if remote else (rank << log_l) | base


def directions(pos0: torch.Tensor, e: int, k: int) -> torch.Tensor:
    """The kernel's direction mask of a group (row_directions): bit u is
    bit k+1 of the row position pos0 | u << e of slot u."""
    b = k + 1 - e
    within = {1: 0xCCCCCCCC, 2: 0xF0F0F0F0, 3: 0xFF00FF00,
              4: 0xFFFF0000}.get(b, 0)
    return torch.where(((pos0 >> (k + 1)) & 1) == 1, 0xFFFFFFFF, 0) ^ within


def key_bits(x: torch.Tensor) -> torch.Tensor:
    """Keys as the integers of their bits (moved so, NaNs keep theirs)."""
    return x.view(torch.int32) if x.dtype == torch.float32 \
        else bitonic.as_bits(x)


def gt_kv(ka, va, kb, vb):
    fa, fb = bitonic.ftz(ka), bitonic.ftz(kb)
    return (fa > fb) | ((fa == fb) & (va > vb))


# The kernel's unsigned representation of a row it sorts by integer
# comparison (sort_tiles.cuh RowKey): the folded key mapped to an
# unsigned integer of the same order, the value biased by 2^31.
_SIGN = {torch.float32: 0x80000000, torch.bfloat16: 0x8000}
_EXP = {torch.float32: 0x7F800000, torch.bfloat16: 0x7F80}
_ONES = {torch.float32: 0xFFFFFFFF, torch.bfloat16: 0xFFFF}


def to_unsigned(keys: torch.Tensor) -> torch.Tensor:
    """RowKey<T>::to on every key, as int64."""
    if keys.dtype == torch.int32:
        return (keys.long() & 0xFFFFFFFF) ^ 0x80000000
    sign, ones = _SIGN[keys.dtype], _ONES[keys.dtype]
    u = key_bits(keys).long() & ones
    u = torch.where((u & _EXP[keys.dtype]) == 0, 0, u)       # fold
    return torch.where((u & sign) != 0, ~u & ones, u | sign)


def from_unsigned(t: torch.Tensor, dtype, original: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """RowKey<T>::from, a key of the zero class taken from the caller's
    row at its column (the slot's value), as the kernel writes it."""
    if dtype == torch.int32:
        u = t ^ 0x80000000
        return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
    sign, ones = _SIGN[dtype], _ONES[dtype]
    u = torch.where((t & sign) != 0, t & (sign - 1), ~t & ones)
    bits_dtype = torch.int32 if dtype == torch.float32 else torch.int16
    u = torch.where(u >= sign, u - 2 * sign, u).to(bits_dtype)
    orig = torch.gather(key_bits(original), 1,
                        torch.clamp(cols, 0, original.shape[1] - 1).long())
    return torch.where(t == sign, orig, u).view(dtype)


def model_sort_kv(keys: torch.Tensor, vals: torch.Tensor,
                  log_slice: int = LOG_SLICE, fast=False):
    """The kernel's schedule on (rows, n) pairs, n a power of two: every
    slot lives in its CTA's swizzled shared memory; each round gathers
    its groups of slots from there, runs its substages on them in the
    direction of the kernel's mask, and scatters them back.  ``fast``:
    in the unsigned representation, as the kernel sorts a row with no
    NaN key (one 64-bit comparison a compare-exchange); "compact": bf16
    keys with the order generated, one 32-bit word a slot, the key over
    the column (0xffff on a pad)."""
    rows, n = keys.shape
    log_total = n.bit_length() - 1
    log_l, log_c = layout(log_total, log_slice)
    ll = 1 << log_l
    kb = keys.element_size()
    pos = torch.arange(n)

    def where(p, key_bytes):            # row position -> shared memory
        return (p >> log_l) * ll + swz(p & (ll - 1), key_bytes,
                                       round_bits(log_l))

    if fast == "compact":               # one 4-byte word a slot
        kb = vb_bytes = 4
        src_k = (to_unsigned(keys) << 16) | torch.where(
            vals == INT32_MAX, 0xFFFF, vals.long())
        src_v = torch.zeros_like(src_k)

        def after(a, va, b, vb):
            return a > b
    elif fast:                          # one packed 8-byte array
        kb = vb_bytes = 8
        src_k = to_unsigned(keys)
        src_v = (vals.long() & 0xFFFFFFFF) ^ 0x80000000

        def after(a, va, b, vb):        # the kernel's 64-bit comparison
            return (a > b) | ((a == b) & (va > vb))
    else:
        vb_bytes = 4
        src_k, src_v = key_bits(keys), vals

        def after(a, va, b, vb):
            return gt_kv(a.view(keys.dtype), va, b.view(keys.dtype), vb)
    sk = torch.empty_like(src_k)
    sk[:, where(pos, kb)] = src_k
    sv = torch.empty_like(src_v)
    sv[:, where(pos, vb_bytes)] = src_v
    for remote, e, k, j_lo, j_hi in rounds(log_total, log_l):
        w = min(round_bits(log_l), log_l)
        base = group_bases(remote, e, w, log_l, log_c).reshape(-1)
        u = torch.arange(1 << w)
        p = base[:, None] | (u[None, :] << e)              # (groups, 2^w)
        gk = sk[:, where(p, kb)]                           # (rows, G, 2^w)
        gv = sv[:, where(p, vb_bytes)]
        steps = ([(kk, j) for kk in k for j in range(kk, -1, -1)]
                 if isinstance(k, range)
                 else [(k, j) for j in range(j_hi, j_lo - 1, -1)])
        for kk, j in steps:
            bit = 1 << (j - e)
            lo = u[(u & bit) == 0]
            hi = lo | bit
            desc = ((directions(base, e, kk)[:, None] >> lo[None, :]) & 1) == 1
            a, b = gk[:, :, lo], gk[:, :, hi]
            va, vb = gv[:, :, lo], gv[:, :, hi]
            swap = after(a, va, b, vb) != desc[None]
            gk, gv = gk.clone(), gv.clone()
            gk[:, :, lo] = torch.where(swap, b, a)
            gk[:, :, hi] = torch.where(swap, a, b)
            gv[:, :, lo] = torch.where(swap, vb, va)
            gv[:, :, hi] = torch.where(swap, va, vb)
        sk[:, where(p, kb)] = gk
        sv[:, where(p, vb_bytes)] = gv
    out_k, out_v = sk[:, where(pos, kb)], sv[:, where(pos, vb_bytes)]
    if not fast:
        return out_k.view(keys.dtype), out_v
    if fast == "compact":
        out_k, out_v = out_k >> 16, (out_k & 0xFFFF).to(torch.int32)
        return from_unsigned(out_k, keys.dtype, keys, out_v), out_v
    out_v = (out_v ^ 0x80000000).to(torch.int32)
    return from_unsigned(out_k, keys.dtype, keys, out_v), out_v


def test_direction_masks_are_the_row_positions_bit():
    """The mask the kernel builds a group equals bit k+1 of each slot's
    row position, for every round of every row length."""
    for log_total in range(1, 17):
        log_l, log_c = layout(log_total)
        w = min(round_bits(log_l), log_l)
        for remote, e, k, _, _ in rounds(log_total, log_l):
            base = group_bases(remote, e, w, log_l, log_c).reshape(-1)
            for kk in (k if isinstance(k, range) else [k]):
                mask = directions(base, e, kk)
                for u in range(1 << w):
                    want = ((base | (u << e)) >> (kk + 1)) & 1
                    assert torch.equal((mask >> u) & 1, want)


def test_rounds_cover_the_network_in_order():
    """Each stage's substages, top down, exactly once, each round's
    substages inside its window and the window inside the row; 30
    rounds a row at 2^16 (the network has 136 substages)."""
    for log_total in range(1, 17):
        log_l, log_c = layout(log_total)
        plan = rounds(log_total, log_l)
        seen = []
        for remote, e, k, j_lo, j_hi in plan:
            w = min(round_bits(log_l), log_l)
            if isinstance(k, range):
                seen += [(kk, j) for kk in k for j in range(kk, -1, -1)]
                continue
            assert e <= j_lo <= j_hi < e + w <= log_total
            assert remote == (j_hi >= log_l)
            if not remote:
                assert e + w <= log_l
            seen += [(k, j) for j in range(j_hi, j_lo - 1, -1)]
        assert seen == [(k, j) for k in range(log_total)
                        for j in range(k, -1, -1)]
        assert log_c <= LOG_MAX_CLUSTER
    assert len(rounds(16, LOG_SLICE)) == 30


def test_warp_local_rounds_touch_only_their_warps_slots():
    """The rounds the kernel separates by a warp's barrier alone (windows
    at e <= 5, or a block of one warp): each warp reads and writes the
    slots it wrote in the first round, so no other warp's write is
    awaited."""
    for log_total in range(1, 17):
        log_l, log_c = layout(log_total)
        nthreads = threads(log_l)
        w = min(round_bits(log_l), log_l)
        owner = {}
        for remote, e, k, _, _ in rounds(log_total, log_l):
            local = e <= 5 or nthreads == 32
            if remote or not local:
                continue
            base = group_bases(remote, e, w, log_l, log_c)  # (CTAs, groups)
            slots = base[..., None] | (torch.arange(1 << w) << e)
            warp = (torch.arange(base.shape[1]) % nthreads) // 32
            warp = warp[None, :, None].expand_as(slots)
            for slot, wp in zip(slots.reshape(-1).tolist(),
                                warp.reshape(-1).tolist()):
                assert owner.setdefault(slot, wp) == wp


def _edge_pairs(rng, rows, n, dtype):
    """Keys with heavy ties, +-0, denormals, +-inf, NaN and the sort
    sentinel; values with ties and int32 max (the pads' value)."""
    if dtype == torch.int32:
        k = rng.integers(-3, 3, (rows, n)).astype(np.int32)
        k.reshape(-1)[::5] = INT32_MAX
        keys = torch.from_numpy(k)
    else:
        pool = np.float32([-1.5, 0.0, -0.0, 2.25, 1e-40, -3e-39, np.inf,
                           -np.inf, np.nan, 7.0])
        k = rng.choice(pool, size=(rows, n)).astype(np.float32)
        k[0] = rng.normal(size=n).astype(np.float32)
        keys = torch.from_numpy(k).to(dtype)
    v = rng.integers(0, 3, (rows, n)).astype(np.int32)
    v.reshape(-1)[::7] = INT32_MAX
    return keys, torch.from_numpy(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("log_n, log_slice, rows", [
    (1, 13, 3), (2, 13, 3), (3, 13, 2), (4, 13, 2), (5, 13, 2), (9, 13, 2),
    (12, 11, 2), (13, 13, 2), (13, 11, 2), (14, 12, 1), (14, 13, 1),
    (15, 13, 1), (16, 13, 1)])
def test_schedule_model_equals_the_network(rng, dtype, log_n, log_slice,
                                           rows):
    """The kernel's rounds, groups, layout and directions give the
    reference network's output bitwise: one CTA (n <= slice) and
    clusters of 2-8 CTAs (slices of 2^11-2^13)."""
    keys, vals = _edge_pairs(rng, rows, 1 << log_n, dtype)
    gk, gv = model_sort_kv(keys, vals, log_slice)
    wk, wv = bitonic.sort_network_block_kv(keys, vals)
    assert torch.equal(key_bits(gk), key_bits(wk))
    assert torch.equal(gv, wv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("log_n, log_slice", [(3, 13), (9, 13), (13, 11),
                                              (14, 13), (16, 13)])
def test_unsigned_representation_equals_the_network(rng, dtype, log_n,
                                                    log_slice):
    """A row with no NaN key, sorted as the kernel sorts it in the
    unsigned representation and rebuilt (a key of the zero class from
    the caller's row at its column), equals the network bitwise: the
    order generated (every dtype, +-0 and denormals among the keys, the
    last three slots pads), for bf16 keys also in the compact 32-bit
    words, and for int32 keys with tied values given."""
    keys, vals = _edge_pairs(rng, 2, 1 << log_n, dtype)
    if dtype != torch.int32:
        keys = torch.where(torch.isnan(keys), torch.zeros_like(keys), keys)
    iota = torch.arange(1 << log_n, dtype=torch.int32).expand(2, -1)
    pad = iota >= (1 << log_n) - 3                      # 3 pads, as loaded
    iota = torch.where(pad, INT32_MAX, iota)
    keys = torch.where(pad, torch.tensor(bitonic.sort_sentinel(dtype),
                                         dtype=dtype), keys)
    cases = [(iota, True)] + ([(vals, True)] if dtype == torch.int32 else
                              [(iota, "compact")]
                              if dtype == torch.bfloat16 else [])
    for v, rep in cases:
        gk, gv = model_sort_kv(keys, v.contiguous(), log_slice, fast=rep)
        wk, wv = bitonic.sort_network_block_kv(keys, v.contiguous())
        real = (1 << log_n) - 3             # the positions the kernel writes
        assert torch.equal(key_bits(gk)[:, :real], key_bits(wk)[:, :real])
        assert torch.equal(gv[:, :real], wv[:, :real])


# ---------------------------------------------------------------------------
# The swizzle: no bank conflict in any warp access
# ---------------------------------------------------------------------------

def _warps(slots: torch.Tensor, nthreads: int):
    """(CTAs, items) slot positions that thread ``item % nthreads`` of
    each CTA takes at step ``item // nthreads`` -> (accesses, <=32)
    tensors, one row a warp access."""
    out = []
    for it in range(0, slots.shape[1], nthreads):
        step = slots[:, it:it + nthreads]
        for w in range(0, step.shape[1], 32):
            out.append(step[:, w:w + 32])
    return out


def _conflict_free(slots: torch.Tensor, owner: torch.Tensor,
                   elem_bytes: int, wr: int) -> bool:
    """slots, owner: (accesses, threads) tile slot and the CTA whose
    shared memory holds it, one warp access a row, through the swizzle.
    Conflict-free: within a CTA's memory no bank serves two different
    4-byte words in one access; an 8-byte access is served a half-warp
    at a time, each slot on a pair of banks."""
    if elem_bytes == 8:
        slots = slots.reshape(-1, 16) if slots.shape[1] % 16 == 0 else slots
        owner = owner.reshape(slots.shape)
        word = swz(slots, 8, wr)                       # an 8-byte word
        bank = owner * 16 + word % 16                  # its bank pair
    else:
        word = (swz(slots, elem_bytes, wr) * elem_bytes) // 4
        bank = owner * 32 + word % 32
    same_bank = bank[:, :, None] == bank[:, None, :]
    other_word = word[:, :, None] != word[:, None, :]
    return not bool((same_bank & other_word).any())


@pytest.mark.parametrize("log_total", [1, 3, 4, 8, 11, 13, 14, 15, 16])
def test_swizzle_is_conflict_free_in_every_round(log_total):
    """Every warp access of every round (each slot u of a group), of the
    coalesced load and of the store, for the packed 8-byte slots and for
    the exact comparator's 4-byte and 2-byte keys and 4-byte values: no
    bank conflict; and each swizzle is a permutation of a CTA's slots."""
    log_l, log_c = layout(log_total)
    ll = 1 << log_l
    nthreads = threads(log_l)
    for elem_bytes in (8, 4, 2):
        assert torch.equal(torch.sort(swz(torch.arange(ll), elem_bytes,
                                          round_bits(log_l))).values,
                           torch.arange(ll))
    # the coalesced load and store: thread t takes slots t + i * threads
    accesses = _warps(torch.arange(ll)[None], nthreads)
    for remote, e, k, j_lo, j_hi in rounds(log_total, log_l):
        w = min(round_bits(log_l), log_l)
        base = group_bases(remote, e, w, log_l, log_c)     # (CTAs, groups)
        for u in range(1 << w):
            accesses += _warps(base | (u << e), nthreads)
    for elem_bytes in (8, 4, 2):
        for warp in accesses:
            assert _conflict_free(warp & (ll - 1), warp >> log_l, elem_bytes,
                                  round_bits(log_l))


# ---------------------------------------------------------------------------
# The plain versions at unpadded widths, the order generated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1077, 52049])
def test_plain_pair_sort_generates_the_reference_iota(rng, m):
    """``bitonic_sort_kv_plain(keys, None)`` is the reference's pair sort
    fed arange(m): the kernel's order channel as it generates it."""
    k = rng.integers(-50, 50, (1, m)).astype(np.int32)
    k[0, ::11] = INT32_MAX
    gk, gv = bitonic.bitonic_sort_kv_plain(torch.from_numpy(k))
    gk2, gv2 = bitonic.bitonic_sort_kv(torch.from_numpy(k))
    iota = np.arange(m, dtype=np.int32)[None]
    wk, wv = jbitonic.bitonic_sort_kv(jnp.asarray(k), jnp.asarray(iota),
                                      block_rows=1)
    for got in ((gk, gv), (gk2, gv2)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(wv))


@pytest.mark.parametrize("m", [1077, 52049])
def test_plain_sort_partition_kv_equals_reference(rng, m):
    x = rng.normal(size=(1, m)).astype(np.float32)
    x[0, ::13] = np.inf
    x[0, :4] = np.float32([1e-40, -0.0, 0.0, -3e-39])
    bounds = np.sort(x[0, rng.permutation(m)[:7]])
    ks, order, cuts = fused.sort_partition_kv_plain(
        torch.from_numpy(x), torch.from_numpy(bounds[None]))
    wks, worder, wcuts = jfused.sort_partition_kv(jnp.asarray(x[0]),
                                                  jnp.asarray(bounds))
    np.testing.assert_array_equal(ks[0].numpy().view(np.int32),
                                  np.asarray(wks).view(np.int32))
    np.testing.assert_array_equal(order[0].numpy(), np.asarray(worder))
    np.testing.assert_array_equal(cuts[0].numpy(), np.asarray(wcuts))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_pair_sort.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("m", [8192, 16384, 32768, 65536, 52049, 2048,
                               70001])
def test_cuda_pair_sorts_equal_plain(card, rng, dtype, m):
    """One CTA (2^13, 2048), clusters of 2, 4 and 8 (2^14-2^16, 52,049),
    and past a cluster's reach (70,001: the split schedule in a scratch):
    the pair sort with the order generated and with tied values given,
    and the fused pair sort's keys, order and cuts, bitwise (63 queries
    drawn from the row, NaN among them: the kernel runs the reference's
    search step for step)."""
    keys, vals = _edge_pairs(rng, 2, m, dtype)
    q = torch.sort(keys[:, rng.permutation(m)[:63]], dim=1).values
    for args in ((keys,), (keys, vals)):
        got = bitonic.bitonic_sort_kv(*(a.to(card) for a in args))
        want = bitonic.bitonic_sort_kv_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(key_bits(g.cpu()), key_bits(w))
    got = fused.sort_partition_kv(keys.to(card), q.to(card))
    for g, w in zip(got, fused.sort_partition_kv_plain(keys, q)):
        assert torch.equal(key_bits(g.cpu()), key_bits(w))


# The sorts' profiled windows run in a child process each, as chip_smoke.py
# opens its windows in a process of its own: in the process that runs
# every card-only file, earlier windows (other files', and this one's
# other cases) left a later window short of one of its kernel events.
# The calls run between two spin kernels (``torch.cuda._sleep``), ~25 ms
# before them so that they run once the profiler records: on the card a
# window with nothing around the calls lost some or all of their
# kernels' events (0 or 4 of 5).  The spins are left out of the names.
PROFILE_CHILD = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import bitonic, cuda, fused
sort, which, rows, m, calls = sys.argv[1], int(sys.argv[2]), \\
    int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
dtype = getattr(torch, sys.argv[6])
torch.manual_seed(0)
if sort == "pairs":
    x = torch.randint(0, 1 << 20, (rows, m), dtype=torch.int32,
                      device="cuda")
    q = torch.arange(1, 8, dtype=torch.int32, device="cuda").expand(
        rows, 7).contiguous() * (1 << 17)
    fn = (lambda: bitonic.bitonic_sort_kv(x),
          lambda: fused.sort_partition_kv(x, q))[which]
else:
    x = torch.randn((rows, m), device="cuda").to(dtype)
    q = torch.sort(x[:, :63]).values[:1].expand(rows, 63).contiguous()
    fn = (lambda: bitonic.bitonic_sort(x),
          lambda: fused.sort_partition(x, q))[which]
fn()
torch.cuda.synchronize()
cuda.reset_launches()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    torch.cuda._sleep(50_000_000)
    for _ in range(calls):
        fn()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
names = [ev.name for ev in prof.events()
         if ev.device_type == torch.autograd.DeviceType.CUDA
         and "spin_kernel" not in ev.name]
print(json.dumps({"names": names, "launches": sum(cuda.LAUNCHES.values())}))
"""


def profiled_kernels(sort: str, which: int, shape, calls: int,
                     dtype: str = "float32"):
    """The device kernels ``calls`` calls of a sort run under
    torch.profiler (names, in order) and the C calls ``cuda.LAUNCHES``
    counts, in a child process (:data:`PROFILE_CHILD`).  ``sort``:
    "pairs" (``which`` 0 ``bitonic_sort_kv``, 1 ``sort_partition_kv``,
    on int32 keys) or "keys" (``bitonic_sort``, ``sort_partition``, on
    ``dtype`` keys)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", PROFILE_CHILD, sort, str(which),
         str(shape[0]), str(shape[1]), str(calls), dtype],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    out = json.loads(run.stdout.strip().splitlines()[-1])
    return out["names"], out["launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 65536), (64, 2048)])
def test_cuda_pair_sort_is_one_kernel_a_call(card, shape):
    """Under torch.profiler, 5 calls of each pair sort run 5 kernels of
    one name: no global pass, no fill, no copy, no iota."""
    for which in (0, 1):        # bitonic_sort_kv, sort_partition_kv
        names, c_calls = profiled_kernels("pairs", which, shape, 5)
        assert len(names) == 5 and len(set(names)) == 1, names
        assert c_calls == 5
