"""The schedule of the onesweep radix kernel (``csrc/radix_sort.cu``),
modelled in numpy on the CPU, against the reference's radix sort.

The kernel cannot run here.  Its arithmetic can: :func:`onesweep` repeats
what the kernel computes, step for step, on the same inputs --

* one upfront histogram of every pass's 8-bit digits of every row;
* each pass over tiles of ``radix.RADIX_TILE`` keys, 8 warps a tile, each
  warp a contiguous run ranked 32 keys a round in lane order (a key's
  rank: the warp's count of its digit in earlier rounds plus its peers in
  lower lanes);
* the warps' offsets and the tile's count per digit, the tile's digit
  starts, the look-back prefix (a scan over the row's earlier tiles per
  (row, digit)) and the row's digit starts from the histogram;
* each key staged at its place in the tile's digit order, then written
  to the row start of its digit + the earlier tiles' count + its place
  in the tile's run;
* raw keys carried (2 or 4 bytes; the digit recomputed from the key) and
  the index generated by the first pass, the buffers ping-ponging
  between a scratch pair and the outputs so the last pass lands in the
  outputs.

The model is held bitwise against the reference's ``radix_sort`` (its
Pallas kernel in interpret mode, 4-bit passes) and the port's plain
version on float32, bf16 and int32 keys of every class that breaks radix
sorts, at widths around the tile.  Tests marked ``cuda`` hold the kernel
itself against the plain version on the card and count its launches.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import radix as jradix
from repro_torch.kernels import radix

from test_radix import N_CASES, adversarial_keys

TILE = radix.RADIX_TILE
BITS = radix.RADIX_KERNEL_BITS
BINS = 1 << BITS
WARPS, LANES = 8, 32                       # csrc/radix_sort.cu kWarps
ROUNDS = TILE // (WARPS * LANES)           # kItems: 16 keys a thread
LOOK = 8                                   # kLook
DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int32": np.int32}
WIDTHS = [1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 17]


def tt(x: np.ndarray) -> torch.Tensor:
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def raw_bits(x: torch.Tensor) -> np.ndarray:
    """The keys' own words: what the kernel loads, moves and stores."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16).copy()
    return x.numpy().view(np.uint32).copy()


def from_raw(raw: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.int32).copy()).view(dtype)


def ready(raw: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The canonical bits of raw key words, as the kernel's ``K::ready``
    computes them (the port's ``sort_ready_bits``, no gather involved)."""
    bits = radix.sort_ready_bits(from_raw(raw, dtype)).numpy()
    return bits.astype(np.int64) & 0xFFFFFFFF


def rank_rounds(d: np.ndarray, valid: np.ndarray) -> tuple:
    """Per-warp multisplit ranks.  d, valid: (..., WARPS, ROUNDS, LANES).
    Returns (ranks of that shape, the warps' digit counts (..., WARPS,
    BINS)): round by round, a key's rank is its warp's count of its digit
    so far plus its peers (same digit, valid) in lower lanes."""
    counts = np.zeros(d.shape[:-2] + (BINS,), np.int64)
    rank = np.zeros(d.shape, np.int64)
    lower = np.tril(np.ones((LANES, LANES), bool), -1)   # [l, l'] l' < l
    for j in range(ROUNDS):
        dj, vj = d[..., j, :], valid[..., j, :]
        peers = ((dj[..., :, None] == dj[..., None, :])
                 & vj[..., None, :] & vj[..., :, None])
        before = np.take_along_axis(counts, dj, axis=-1)
        rank[..., j, :] = before + (peers & lower).sum(-1)
        counts += ((dj[..., None] == np.arange(BINS)) & vj[..., None]).sum(-2)
    return rank, counts


def exclusive(a: np.ndarray, axis: int) -> np.ndarray:
    return np.cumsum(a, axis=axis) - a


def onesweep(x: torch.Tensor, trace: list = None):
    """The kernel's result, by its schedule.  x: (rows, n) keys.
    Returns (sorted keys, int32 order) as torch tensors; appends each
    pass's (read buffer, written buffer) to ``trace``."""
    rows, n = x.shape
    passes = radix.key_bits(x.dtype) // BITS
    tiles = -(-n // TILE)
    raw0 = raw_bits(x)
    # the upfront histogram: every pass's digits of x, counted once
    r0 = ready(raw0, x.dtype)
    hist = np.stack([(((r0 >> (BITS * p)) & (BINS - 1))[..., None]
                      == np.arange(BINS)).sum(1) for p in range(passes)], 1)
    width = tiles * TILE
    e = np.arange(width)
    valid = (e < n).reshape(tiles, WARPS, ROUNDS, LANES)
    tile_of = (e // TILE).reshape(tiles, WARPS, ROUNDS, LANES)
    bufs = {"x": (raw0, None)}
    for p in range(passes):
        src = "x" if p == 0 else ("a" if p % 2 else "out")
        dst_name = "out" if p % 2 else "a"
        assert src != dst_name
        if trace is not None:
            trace.append((src, dst_name))
        raw, idx = bufs[src]
        if idx is None:                  # the first pass generates it
            idx = np.broadcast_to(np.arange(n), (rows, n))
        pad = lambda a: np.pad(a, ((0, 0), (0, width - n))).reshape(
            rows, tiles, WARPS, ROUNDS, LANES)
        d = pad((ready(raw, x.dtype) >> (BITS * p)) & (BINS - 1))
        rank, counts = rank_rounds(d, np.broadcast_to(valid, d.shape))
        warp_off = exclusive(counts, 2)                    # (rows, tiles, W, B)
        tile_cnt = counts.sum(2)                           # (rows, tiles, B)
        tile_start = exclusive(tile_cnt, 2)
        prefix = exclusive(tile_cnt, 1)                    # the look-back
        row_start = exclusive(hist[:, p], 1)               # (rows, B)
        # the look-back's last inclusive prefix is the histogram's count
        np.testing.assert_array_equal(prefix[:, -1] + tile_cnt[:, -1],
                                      hist[:, p])
        ri = np.arange(rows)[:, None, None, None, None]
        ti = tile_of[None]
        wi = np.arange(WARPS)[None, None, :, None, None]
        stage = (tile_start[ri, ti, d] + warp_off[ri, ti, wi, d] + rank)
        out_at = row_start[ri, d] + prefix[ri, ti, d] + stage \
            - tile_start[ri, ti, d]
        ok = np.broadcast_to(valid, d.shape)
        stage = stage[ok].reshape(rows, n)
        out_at = out_at[ok].reshape(rows, n)
        # a tile's staging is a permutation of its places, the pass's
        # destinations one of the row's
        for t in range(tiles):
            lo, hi = t * TILE, min(n, (t + 1) * TILE)
            assert (np.sort(stage[:, lo:hi], 1) == np.arange(hi - lo)).all()
        assert (np.sort(out_at, 1) == np.arange(n)).all()
        new_raw = np.empty_like(raw)
        new_idx = np.empty((rows, n), np.int64)
        np.put_along_axis(new_raw, out_at, raw, 1)
        np.put_along_axis(new_idx, out_at, idx, 1)
        bufs[dst_name] = (new_raw, new_idx)
    assert dst_name == "out"
    raw, idx = bufs["out"]
    return from_raw(raw, x.dtype), torch.from_numpy(idx.astype(np.int32))


def lookback(counts: list, published: list) -> int:
    """The kernel's batched look-back of one (tile, digit): ``counts[k]``
    the earlier tiles' counts; ``published[k]`` what each poll of tile
    k's word reads, in turn ("none", "agg" or "prefix"; the last state
    stays).  Returns the sum the kernel adds up."""
    prefix_of = np.cumsum([0] + counts)              # inclusive prefixes
    polls = [0] * len(counts)

    def word(k):
        if k < 0:
            return "none"
        state = published[k][min(polls[k], len(published[k]) - 1)]
        polls[k] += 1
        return state

    k, before, done = len(counts) - 1, 0, False
    while not done:
        words = [word(k - q) for q in range(LOOK)]
        for w in words:
            if done or w == "none":
                break
            before += prefix_of[k + 1] if w == "prefix" else counts[k]
            k -= 1
            done = w == "prefix"
    return before


def keys(dtype: str, case: int, rows: int, n: int) -> np.ndarray:
    return np.stack([adversarial_keys(DTYPES[dtype], case, n,
                                      seed=case * 17 + r + n)
                     for r in range(rows)])


def bits(a) -> np.ndarray:
    """Keys or orders as integers: floats by their bits."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


# ---------------------------------------------------------------------------
# the model against the reference and the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_matches_reference_on_every_class(dtype, n):
    """Every class of bits (NaN of both signs and payloads, +-0,
    denormals, +-inf, duplicates, one digit, high digits) a row each."""
    x = np.concatenate([keys(dtype, c, 1, n) for c in range(N_CASES)])
    if dtype != "int32":
        extra = np.float32([np.nan, -0.0, 1e-40, -np.inf, 2.5])
        extra = np.resize(extra, n).view(np.uint32)
        extra[::3] = 0x7fc00001                        # NaN payloads
        extra[1::7] = 0xffc00123
        x = np.concatenate([x, extra.view(np.float32)[None]
                            .astype(DTYPES[dtype])])
    got = onesweep(tt(x))
    assert_same(got, jradix.radix_sort(jnp.asarray(x)))
    assert_same(got, radix.radix_sort_plain(tt(x)))


@pytest.mark.parametrize("rows,n", [(64, 1), (64, TILE - 1), (2, TILE + 1),
                                    (1, 3 * TILE + 17)])
@pytest.mark.parametrize("kind", ["all_equal", "digit_per_tile", "zipf"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_matches_reference_on_ties(dtype, kind, rows, n):
    """All-equal rows, rows whose keys share one digit in each tile (a
    tile's keys all equal, the tiles different), and Zipf ties (37
    values)."""
    rng = np.random.default_rng(rows + n)
    if kind == "all_equal":
        x = np.full((rows, n), -3.0)
    elif kind == "digit_per_tile":
        x = np.broadcast_to((np.arange(n) // TILE) * 37.0 - 5.0, (rows, n))
    else:
        x = rng.zipf(1.5, (rows, n)) % 37 - 18.0
    x = np.ascontiguousarray(x).astype(DTYPES[dtype])
    got = onesweep(tt(x))
    assert_same(got, jradix.radix_sort(jnp.asarray(x)))
    assert_same(got, radix.radix_sort_plain(tt(x)))


@pytest.mark.parametrize("dtype,passes", [("float32", 4), ("int32", 4),
                                          ("bfloat16", 2)])
def test_model_ping_pongs_into_the_outputs(dtype, passes):
    """x -> a -> out -> a -> out for 32-bit keys, x -> a -> out for bf16:
    one pass a launch, the last into the outputs, none in place."""
    trace = []
    onesweep(tt(keys(dtype, 0, 2, 9)), trace)
    want = [("x", "a"), ("a", "out"), ("out", "a"), ("a", "out")][:passes]
    assert trace == want


@pytest.mark.parametrize("seed", range(6))
def test_batched_lookback_sums_the_earlier_tiles(seed):
    """The look-back loads kLook words at a time and sums them back from
    the nearest until a PREFIX; a word not yet published ends the batch
    and is polled again.  Whatever the states, it sums every earlier
    tile's count."""
    rng = np.random.default_rng(seed)
    tiles = int(rng.integers(1, 40))
    counts = [int(c) for c in rng.integers(0, 500, tiles)]
    published = []
    for k in range(tiles):
        polls = ["none"] * int(rng.integers(0, 3))
        final = "prefix" if k == 0 or rng.random() < 0.3 else "agg"
        if final == "prefix" and k > 0 and rng.random() < 0.5:
            polls.append("agg")             # an AGGREGATE before the PREFIX
        published.append(polls + [final])
    assert lookback(counts, published) == sum(counts)


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version, and its launches
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", WIDTHS + [1 << 16, 1 << 18])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_onesweep_equals_plain(card, dtype, n):
    rows = 2 if n > TILE * 4 else 1
    x = tt(np.concatenate([keys(dtype, c, rows, n) for c in range(N_CASES)]))
    got = radix.radix_sort(x.to(card))
    assert got[0].is_cuda and got[1].is_cuda
    assert_same(got, radix.radix_sort_plain(x.to(card)))


# The profiled window runs in a child process: a torch.profiler window
# over these calls (a memset among the kernels) left later windows of the
# same process without some or all of their kernel events on the card,
# so the sort files' one-kernel-a-call tests after it failed.
PROFILE_CHILD = """
import collections, json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import cuda, radix
x = torch.randint(-1000, 1000, (64, 65536), device="cuda").to(
    getattr(torch, sys.argv[1]))
radix.radix_sort(x)
torch.cuda.synchronize()
cuda.reset_launches()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    torch.cuda._sleep(50_000_000)
    for _ in range(5):
        radix.radix_sort(x)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
names = [ev.name for ev in prof.events()
         if ev.device_type == torch.autograd.DeviceType.CUDA
         and "spin_kernel" not in ev.name]
print(json.dumps({"names": names, "launches": dict(cuda.LAUNCHES)}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [("float32", 5), ("int32", 5),
                                           ("bfloat16", 3)])
def test_cuda_radix_sort_launches_a_histogram_and_a_kernel_a_pass(
        card, dtype, kernels):
    """Under torch.profiler, one call is one C call, one memset and
    1 + key_bits / 8 kernels: the histogram and one onesweep pass each."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", PROFILE_CHILD, dtype],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    out = json.loads(run.stdout.strip().splitlines()[-1])
    names = out["names"]
    kernel_names = [nm for nm in names if "emset" not in nm]
    assert len(names) - len(kernel_names) == 5, names      # the memsets
    assert len(kernel_names) == 5 * kernels, names
    assert sum("upfront_histogram" in nm for nm in kernel_names) == 5
    assert sum("onesweep_pass" in nm for nm in kernel_names) == \
        5 * (kernels - 1)
    assert out["launches"] == {"radix_sort": 5}
