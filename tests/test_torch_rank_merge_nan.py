"""The rank merge on rows that hold a NaN, against the reference (ROADMAP C15).

The reference's ``ops._rank_merge`` pads each (t, c) entry to (pow2 t,
pow2 c) with the sort sentinel and unique pad ids, ranks every padded
pair by its fixed-step searches (whole rows where the padded row is
2,048 slots or fewer, else blocks of ``RANK_MERGE_BOUND_BLOCK``), and
scatters keys and ids into zeros.  A NaN compares false both ways, so
on a row that holds one the searches are not monotone: ranks collide
(the last source in flat order wins), some places are never written
(key 0, id 0), a pad can land among the first t*c places, and the
blocked sums differ from a whole-row search.  The port replays all of
it on the entries that hold a NaN; these tests hold it to the
reference bitwise, keys (bf16 as int16 bits) and order at every place,
the reference running its Pallas rank kernel in interpret mode:

* ROADMAP's C15 reproduction (t = 4, c = 16,500: blocked);
* a NaN in a row's first, middle and last real slot, alone and
  several, f32 and bf16, padded rows of 2,048 slots or fewer (whole
  rows, also at t = 64 x c = 1,500) and wider (blocked);
* a batch of two where one entry holds a NaN;
* ``ops.merge_sorted_rows`` and ``merge_sorted_rows_kv`` past one tile;
* the ranks' contract ``fused.merge_ranks(keys, ids, bound_block)``
  against the reference's for bound_block None and 2048;
* a constructed collision, which pins "the last source wins";
* ``cluster.sort`` end to end (SMMS and Terasort with values) at the
  smallest t = 2 shapes whose Round 3 takes the rank merge.

Rows without a NaN keep the exact merge; ``test_torch_rank_merge.py``
holds that.  The card's replay kernel is held against these plain
versions by ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro.kernels import bitonic as jbitonic
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro_torch import cluster
from repro_torch.kernels import bitonic, fused, ops

from test_torch_terasort import assert_reports_equal, reference_uniforms


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def as_jax(xt: torch.Tensor):
    if xt.dtype == torch.bfloat16:
        return jnp.asarray(xt.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(xt.numpy())


def nan_rows(seed: int, t: int, c: int, where,
             dtype="float32") -> torch.Tensor:
    """(t, c) sorted normal rows with NaN put in place afterwards, as the
    keys-only network leaves them; ``where``: (row, col) pairs.  A bf16
    NaN is the quiet NaN 0x7fc0, whose bits the reference's ``jnp.pad``
    keeps on the CPU (it rewrites other payloads: 0xffff becomes
    0xffc0)."""
    x = np.sort(np.random.default_rng(seed).standard_normal(
        (t, c)).astype(np.float32), axis=1)
    for r, col in where:
        x[r, col] = np.nan
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
        xt.view(torch.int16)[torch.isnan(xt)] = 0x7fc0
    return xt


def assert_rank_merge_matches(xt: torch.Tensor) -> None:
    """``ops._rank_merge`` of (t, c) rows against the reference's."""
    merged, order = ops._rank_merge(xt[None], with_order=True)
    wm, wo = jops._rank_merge(as_jax(xt))
    assert_bitwise(merged[0], wm)
    assert_bitwise(order[0], wo)


def test_c15_reproduction_matches_reference():
    """ROADMAP C15: before the replay the port differed at 10 of 66,000
    places -- 29 and 36,255-36,262 never written (the reference's key
    0.0 and id 0 there), 65,999 the reference's pad (+inf, id 82,500)."""
    x = nan_rows(1, 4, 16500, [(1, 5), (2, 9000), (3, 16499)])
    merged, order = ops._rank_merge(x[None], with_order=True)
    wm, wo = jops._rank_merge(jnp.asarray(x.numpy()))
    assert_bitwise(merged[0], wm)
    assert_bitwise(order[0], wo)
    wo = np.asarray(wo)
    assert wo[65999] == 82500 and np.asarray(wm)[65999] == np.inf
    assert (wo[[29, *range(36255, 36263)]] == 0).all()


SLOTS = {"first": lambda t, c: [(1, 0)],
         "middle": lambda t, c: [(t - 1, c // 2)],
         "last": lambda t, c: [(0, c - 1)],
         "several": lambda t, c: [(0, 0), (0, 1), (1, c // 3), (1, c - 1),
                                  (t - 1, c // 2), (t - 1, c - 1)]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,c", [(5, 300), (3, 2100)],
                         ids=["whole-rows", "blocked"])
@pytest.mark.parametrize("where", list(SLOTS))
def test_nan_slots_match_reference(where, t, c, dtype):
    """c = 300 pads to 512 slots (whole-row searches), c = 2,100 to 4,096
    (two bound blocks of 2,048)."""
    assert_rank_merge_matches(nan_rows(7, t, c, SLOTS[where](t, c), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sixty_four_rows_of_whole_row_searches(dtype):
    """t = 64 x c = 1,500: padded (64, 2048), the widest whole-row case."""
    where = [(0, 0), (13, 700), (40, 1499), (63, 1499), (63, 3)]
    assert_rank_merge_matches(nan_rows(3, 64, 1500, where, dtype))


def test_batch_with_one_nan_entry():
    """The entry without a NaN keeps the exact merge, the other the
    replay; each equals the reference."""
    clean = nan_rows(11, 3, 2100, [])
    dirty = nan_rows(12, 3, 2100, [(0, 2099), (2, 1000)])
    xt = torch.stack([clean, dirty])
    merged, order = ops._rank_merge(xt, with_order=True)
    for b in range(2):
        wm, wo = jops._rank_merge(as_jax(xt[b]))
        assert_bitwise(merged[b], wm)
        assert_bitwise(order[b], wo)
    exact = fused._merge_exact(clean[None])
    assert_bitwise(merged[0], exact[0][0])
    assert_bitwise(order[0], exact[1][0])


def test_merge_sorted_rows_past_one_tile_match_reference():
    """Keys only and with values through the dispatch: t = 33 x c =
    1,025 pads to 64 x 2,048 slots, past one tile (the rank merge)."""
    t, c = 33, 1025
    xt = nan_rows(5, t, c, [(2, 0), (17, 512), (32, 1024)])
    assert not ops._merge_fits_one_tile(t, c)
    v = np.arange(t * c, dtype=np.int32).reshape(t, c) * 3 + 1
    wk, wv = jops.merge_sorted_rows_kv(as_jax(xt), jnp.asarray(v),
                                       backend="pallas")
    assert_bitwise(ops.merge_sorted_rows(xt), wk)
    gk, gv = ops.merge_sorted_rows_kv(xt, torch.from_numpy(v))
    assert_bitwise(gk, wk)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("bound_block", [None, 2048])
@pytest.mark.parametrize("padded", [True, False])
def test_merge_ranks_contract_matches_reference(padded, bound_block):
    """``fused.merge_ranks`` on rows with NaN: the reference's padded
    operands (4, 4096) and, as a direct caller hands them, unpadded
    (3, 3000) rows with flat ids.  A NaN at column 2,048 (1,500) is the
    first probe of every whole-row search of its row, not of a blocked
    one: the blocked and whole-row ranks differ, and each is the
    reference's."""
    x = nan_rows(9, 3, 3000, [(0, 5), (1, 2048), (2, 1500), (2, 2999)])
    if padded:
        kp = jbitonic._pad_sorted_rows(jnp.asarray(x.numpy()),
                                       jbitonic.sort_sentinel(jnp.float32))
        ip = jbitonic._pad_iota_unique(3, 3000, *kp.shape)
    else:
        kp = jnp.asarray(x.numpy())
        ip = jnp.arange(9000, dtype=jnp.int32).reshape(3, 3000)
    want = jfused.merge_ranks(kp, ip, bound_block=bound_block)
    kt = torch.from_numpy(np.array(kp))[None]
    it = torch.from_numpy(np.array(ip))[None]
    got = fused.merge_ranks(kt, it, bound_block)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    other = fused.merge_ranks_plain(kt, it,
                                    2048 if bound_block is None else None)
    assert not torch.equal(got, other)   # the blocking shows on NaN rows


def test_collision_keeps_the_last_source():
    """Every NaN query ranks 0 in every row (its compares are all
    false), so the three NaN pairs collide at place 0, with -1.0, whose
    searches meet the NaN on their way; JAX's scatter keeps the last in
    flat order, the NaN at (2, 1), id 2 * 3 + 1."""
    x = torch.tensor([[np.nan, 1.0, 2.0], [0.5, 1.5, np.nan],
                      [-1.0, np.nan, 3.0]], dtype=torch.float32)
    kp, ip, cp2 = bitonic._padded_slots(x[None])
    pos = fused.merge_ranks_plain(kp.reshape(1, -1, cp2),
                                  ip.reshape(1, -1, cp2))
    sources = (pos.reshape(-1) == 0).nonzero().reshape(-1).tolist()
    assert sources == [0, cp2 + 2, 2 * cp2, 2 * cp2 + 1]
    merged, order = ops._rank_merge(x[None], with_order=True)
    assert order[0, 0] == 7 and torch.isnan(merged[0, 0])
    assert_rank_merge_matches(x)


@pytest.mark.parametrize("algorithm,m", [("smms", 32768),
                                         ("terasort", 16384)])
def test_cluster_sort_with_nan_through_the_rank_merge(algorithm, m):
    """t = 2: the smallest machine count, and the smallest m a power of
    two, whose Round 3 lands rows past one tile (SMMS (2, 2, 34407),
    Terasort (2, 2, 45057)); three NaN among the keys, with values."""
    t = 2
    x = np.random.default_rng(0).standard_normal((t, m)).astype(np.float32)
    x[0, 100] = x[1, 7] = x[1, m - 1] = np.nan
    v = np.arange(t * m, dtype=np.int32).reshape(t, m)
    landed = []
    merge = fused.rank_merge

    def tapped(keys):
        landed.append(tuple(keys.shape))
        return merge(keys)

    fused.rank_merge = tapped
    try:
        extra = ({"uniforms": reference_uniforms(0, t, m)}
                 if algorithm == "terasort" else {})
        (gk, gv), got = cluster.sort(x, algorithm=algorithm, values=v,
                                     seed=0, device="cpu", **extra)
    finally:
        fused.rank_merge = merge
    assert landed and not ops._merge_fits_one_tile(*landed[0][-2:])
    (wk, wv), want = jcluster.sort(x, algorithm=algorithm, values=v, seed=0,
                                   kernel_backend="pallas")
    assert_bitwise(gk, wk)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert_reports_equal(got, want)
