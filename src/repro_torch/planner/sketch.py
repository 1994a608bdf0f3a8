"""Data sketches -- the planner's one-round statistics phase, on the card.

Counterpart of ``src/repro/planner/sketch.py``, batched over the t
shards (every field of a :class:`ShardSketch` carries the shard axis
first).  Three sketches a shard:

* **Heavy hitters** -- the top ``HH_K`` keys with counts.  Where the
  reference's gate admits the (sampled) shard (its ``ops.kernel_eligible
  ("sort", ...)``: float32/bfloat16/int32 keys, a padded row of at most
  2^16 lanes) this is the *sorted-runs* pass: ``ops.sort`` of the rows,
  then ``ops.searchsorted`` of every row against itself with
  ``side="left"`` and ``side="right"`` (per-row queries) give exact run
  lengths, and the heaviest runs are kept.  Elsewhere a
  :func:`misra_gries` pass (a plain torch loop over the keys, batched
  over the shards).  The port's own gate admits more (ROADMAP C10), so
  the branch mirrors the reference's decision, not the port's.
* **CountMin** -- a (depth, width) table of hashed counts, filled by an
  int32 ``index_put_(accumulate=True)`` (exact for integers, in any
  order).  All shards share the row salts, so tables merge by addition.
* **KMV distinct count** -- the ``KMV_K`` smallest distinct hash values.

The hashes are the reference's uint32 arithmetic, computed in int64 and
masked to 32 bits (torch has few uint32 ops, ROADMAP C7); the products
are split so no int64 overflows.  ``lax.top_k`` puts the lower index
first among ties; the port takes the heavy hitters by a stable
descending sort, which does the same.  The host merge
(:func:`merge_shard_sketches`, :func:`build_data_profile`) is the
reference's numpy, copied.  The sketch round is a ``round0 sketch``
phase on the substrate's tape: each machine ships its fixed-size sketch
and receives all t.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.bitonic import KEY_DTYPES, _next_pow2

__all__ = [
    "HH_K", "CM_DEPTH", "CM_WIDTH", "KMV_K", "SKETCH_SAMPLE", "SKETCH_PHASE",
    "ShardSketch", "TableProfile", "DataProfile",
    "misra_gries", "shard_sketch", "sketch_size", "countmin_query",
    "merge_shard_sketches", "build_data_profile", "sketch_table",
    "profile_sorted_shards", "profile_join_tables", "expert_counts_estimate",
]

HH_K = 8          # heavy-hitter slots per shard
CM_DEPTH = 3      # CountMin rows
CM_WIDTH = 512    # CountMin columns (power of two)
KMV_K = 64        # distinct-count minima retained
# The per-shard work cap: longer shards are strided down to ~this many
# keys and the sketch counts scaled back up.
SKETCH_SAMPLE = 512

_I32_MAX = np.iinfo(np.int32).max
_U32 = 0xFFFFFFFF
# Odd multiplicative salts; row d of every shard's CountMin uses salt d.
_CM_SALTS = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F],
                     dtype=np.uint32)
_KMV_SALT = np.uint32(0x2545F491)
# The reference's lane gate (src/repro/kernels/ops.py:_lanes_ok): the
# sorted-runs pass runs where a padded row fits 2^16 lanes.
_REFERENCE_LANES = 1 << 16


class ShardSketch(NamedTuple):
    """The t shards' fixed-size summaries (shard axis first)."""
    n: torch.Tensor            # (t,) int32 valid (unmasked) objects
    heavy_keys: torch.Tensor   # (t, HH_K) key dtype
    heavy_counts: torch.Tensor  # (t, HH_K) int32, 0 = empty (sample counts)
    countmin: torch.Tensor     # (t, CM_DEPTH, CM_WIDTH) int32 (sample counts)
    kmv: torch.Tensor          # (t, KMV_K) int32 ascending minima
    scale: torch.Tensor        # (t,) int32 subsample stride


def sketch_size(hh_k: int = HH_K, cm_depth: int = CM_DEPTH,
                cm_width: int = CM_WIDTH, kmv_k: int = KMV_K) -> int:
    """Objects in one shard sketch -- the sketch phase's network unit."""
    return 1 + 2 * hh_k + cm_depth * cm_width + kmv_k


def _to_u32(keys: torch.Tensor) -> torch.Tensor:
    """32-bit keys' bits as int64 in [0, 2^32) (the reference's bitcast
    to uint32, float32 and int32 keys only, as there)."""
    if keys.dtype == torch.float32:
        keys = keys.view(torch.int32)
    elif keys.dtype != torch.int32:
        raise ValueError(f"the sketches hash 32-bit keys (float32 or "
                         f"int32), got {keys.dtype}")
    return keys.long() & _U32


def _mul_u32(a: torch.Tensor, salt) -> torch.Tensor:
    """a * salt mod 2^32 for a in [0, 2^32), in int64 without overflow:
    the salt is split into 16-bit halves."""
    salt = torch.as_tensor(salt, dtype=torch.int64, device=a.device)
    lo, hi = salt & 0xFFFF, salt >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _cm_hash(keys_u32: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """(..., depth, n) int64 CountMin column ids of (..., n) hashed keys."""
    salts = torch.as_tensor(_CM_SALTS[:depth].astype(np.int64),
                            device=keys_u32.device)[:, None]
    h = (_mul_u32(keys_u32[..., None, :], salts) + (salts >> 3)) & _U32
    h = h ^ (h >> 15)
    return h % width


def _kmv_hash(keys_u32: torch.Tensor) -> torch.Tensor:
    """int32 hash in [0, 2^31) -- KMV needs an orderable hash."""
    h = (_mul_u32(keys_u32, int(_KMV_SALT)) + 0x9E3779B9) & _U32
    h = h ^ (h >> 16)
    return (h >> 1).to(torch.int32)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, the lower index
    first among ties (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def misra_gries(keys: torch.Tensor, k: int, masked=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming Misra-Gries heavy hitters, k slots, one pass.

    keys: (n,) or (t, n), each row its own stream.  Returns
    ``(slot_keys, slot_counts)`` ((k,) or (t, k)); a slot count of 0
    means empty.  The reference's ``lax.scan`` step, as a loop over the
    keys batched over the rows.  ``masked`` keys are skipped.
    """
    k2 = keys[None] if keys.dim() == 1 else keys
    rows = k2.shape[0]
    iota = torch.arange(k, device=keys.device)
    sk = torch.zeros((rows, k), dtype=keys.dtype, device=keys.device)
    sc = torch.zeros((rows, k), dtype=torch.int32, device=keys.device)
    for i in range(k2.shape[1]):
        x = k2[:, i:i + 1]
        match = (sk == x) & (sc > 0)
        has = match.any(dim=1, keepdim=True)
        empty = sc == 0
        any_empty = empty.any(dim=1, keepdim=True)
        first_empty = empty.int().argmax(dim=1, keepdim=True)
        ins = ~has & any_empty & (iota == first_empty)
        dec = ~has & ~any_empty
        nk = torch.where(ins, x, sk)
        nc = torch.where(match, sc + 1,
                         torch.where(ins, 1, torch.where(dec, sc - 1, sc)))
        if masked is not None:
            valid = x != masked
            nk = torch.where(valid, nk, sk)
            nc = torch.where(valid, nc, sc)
        sk, sc = nk, nc.to(torch.int32)
    return (sk[0], sc[0]) if keys.dim() == 1 else (sk, sc)


def _pad_to(x: torch.Tensor, k: int, value=0) -> torch.Tensor:
    if x.shape[-1] >= k:
        return x
    return torch.nn.functional.pad(x, (0, k - x.shape[-1]), value=value)


def _reference_sorts(keys: torch.Tensor) -> bool:
    """The reference's ``ops.kernel_eligible("sort", keys)`` on one
    shard's (sampled) row: the branch it takes."""
    return (keys.dtype in KEY_DTYPES
            and _next_pow2(keys.shape[-1]) <= _REFERENCE_LANES)


def shard_sketch(keys: torch.Tensor, *, hh_k: int = HH_K,
                 cm_depth: int = CM_DEPTH, cm_width: int = CM_WIDTH,
                 kmv_k: int = KMV_K, masked=None,
                 sample: Optional[int] = None) -> ShardSketch:
    """One pass over each shard: heavy hitters + CountMin + KMV minima.

    keys: (t, n) shards (or one (n,) shard: the fields then lose the
    shard axis).  ``masked`` is the padding sentinel (``MASKED_KEY`` for
    dealt join shards, None for dense sort shards); masked slots count
    in no sketch.  ``sample`` strides longer shards down to ~sample keys
    and returns the stride as ``scale`` (``n`` stays the exact count).
    """
    if keys.dim() == 1:
        return ShardSketch(*(f[0] for f in shard_sketch(
            keys[None], hh_k=hh_k, cm_depth=cm_depth, cm_width=cm_width,
            kmv_k=kmv_k, masked=masked, sample=sample)))
    t, n_full = keys.shape
    dev = keys.device
    full_valid = (torch.ones(keys.shape, dtype=torch.bool, device=dev)
                  if masked is None else keys != masked)
    n_valid = full_valid.sum(dim=1).to(torch.int32)

    stride = 1
    if sample is not None and n_full > sample:
        stride = -(-n_full // sample)
        keys = keys[:, ::stride].contiguous()
    n = keys.shape[1]
    valid = full_valid[:, ::stride] if stride > 1 else full_valid
    ku = _to_u32(keys)
    kk = min(kmv_k, n)

    if _reference_sorts(keys):
        # the sorted-runs pass: exact run lengths from two searches of
        # every sorted row against itself
        xs = ops.sort(keys)
        lo = ops.searchsorted(xs, xs, side="left")
        hi = ops.searchsorted(xs, xs, side="right")
        first = lo == torch.arange(n, dtype=lo.dtype, device=dev)
        if masked is not None:
            first = first & (xs != masked)
        cnt = torch.where(first, hi - lo, 0)
        hc, idx = _top_k(cnt, min(hh_k, n))
        hk = torch.gather(xs, 1, idx)
        hv = torch.where(first, _kmv_hash(_to_u32(xs)), _I32_MAX)
        mins = torch.sort(hv, dim=1).values[:, :kk]     # the kk smallest
    else:
        sk, sc = misra_gries(keys, hh_k, masked=masked)
        hc, idx = _top_k(sc, hh_k)
        hk = torch.gather(sk, 1, idx)
        hv = torch.where(valid, _kmv_hash(ku), _I32_MAX)
        hs = ops.sort(hv)
        prev = torch.cat([torch.full((t, 1), -1, dtype=torch.int32,
                                     device=dev), hs[:, :-1]], dim=1)
        dedup = torch.where(hs == prev, _I32_MAX, hs)
        mins = torch.sort(dedup, dim=1).values[:, :kk]
    hk = _pad_to(hk, hh_k)
    hc = _pad_to(hc.to(torch.int32), hh_k)
    mins = _pad_to(mins, kmv_k, value=_I32_MAX)

    # CountMin: one scatter-add, shared salts across shards
    h = _cm_hash(ku, cm_depth, cm_width)                    # (t, depth, n)
    cm = torch.zeros((t, cm_depth, cm_width), dtype=torch.int32, device=dev)
    shard = torch.arange(t, device=dev)[:, None, None].expand_as(h)
    row = torch.arange(cm_depth, device=dev)[None, :, None].expand_as(h)
    cm.index_put_((shard, row, h), valid.to(torch.int32)[:, None, :]
                  .expand_as(h), accumulate=True)
    return ShardSketch(n_valid, hk, hc, cm, mins,
                       torch.full((t,), stride, dtype=torch.int32,
                                  device=dev))


# ---------------------------------------------------------------------------
# host-side merge -> TableProfile / DataProfile (the reference's numpy)
# ---------------------------------------------------------------------------

def countmin_query(cm: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Point-query a (merged) CountMin table: min over rows, >= truth.

    numpy mirror of :func:`_cm_hash` (uint32 arithmetic wraps)."""
    keys = np.atleast_1d(np.asarray(keys))
    if keys.dtype.kind in "iu":
        ku = keys.astype(np.int32, copy=False).view(np.uint32)
    else:
        ku = keys.astype(np.float32, copy=False).view(np.uint32)
    depth, width = cm.shape
    salts = _CM_SALTS[:depth][:, None]
    h = ku[None, :] * salts + (salts >> 3)
    h = h ^ (h >> np.uint32(15))
    idx = (h % np.uint32(width)).astype(np.int64)
    return np.min(cm[np.arange(depth)[:, None], idx], axis=0)


@dataclasses.dataclass(frozen=True)
class TableProfile:
    """Merged sketch summary of one table (or one (t, m) sort input)."""
    n: int                     # total valid objects
    t: int                     # shards merged
    distinct: float            # KMV estimate
    heavy_keys: np.ndarray     # (<=HH_K,) heaviest keys, count-descending
    heavy_counts: np.ndarray   # (<=HH_K,) CountMin-refined count estimates
    countmin: np.ndarray       # (depth, width) merged table

    @property
    def duplication(self) -> float:
        """Average copies per distinct key (1.0 = all keys unique)."""
        return self.n / max(self.distinct, 1.0)

    @property
    def top_count(self) -> float:
        return float(self.heavy_counts[0]) if len(self.heavy_counts) else 0.0

    @property
    def top_share(self) -> float:
        return self.top_count / max(self.n, 1)


def _kmv_estimate(minima: np.ndarray, kmv_k: int) -> float:
    u = np.unique(minima)
    u = u[u < _I32_MAX]
    if len(u) == 0:
        return 0.0
    if len(u) < kmv_k:
        return float(len(u))          # saw every distinct hash -- exact
    kth = float(u[kmv_k - 1])
    return (kmv_k - 1) / ((kth + 1.0) / 2.0**31)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def merge_shard_sketches(sk: ShardSketch, hh_k: int = HH_K,
                         kmv_k: int = KMV_K) -> TableProfile:
    """Merge the t shard sketches host-side (one copy of each field).

    Subsampled shards (scale > 1) have their heavy/CountMin counts
    multiplied back up; ``n`` is exact regardless."""
    n_shards = _host(sk.n).reshape(-1)
    t = len(n_shards)
    n = int(n_shards.sum())
    scale = _host(sk.scale).astype(np.int64).reshape(-1)         # (t,)
    cm = (_host(sk.countmin).astype(np.int64)
          .reshape(t, *sk.countmin.shape[-2:])
          * scale[:, None, None]).sum(axis=0)

    hk = _host(sk.heavy_keys).reshape(t, -1)
    hc = _host(sk.heavy_counts).astype(np.int64).reshape(t, -1) \
        * scale[:, None]
    agg = {}
    for key, cnt in zip(hk.reshape(-1), hc.reshape(-1)):
        if cnt > 0:
            agg[key.item()] = agg.get(key.item(), 0) + int(cnt)
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:hh_k]
    if top:
        keys = np.asarray([k for k, _ in top], dtype=hk.dtype)
        # the merged sums are lower bounds, the CountMin an upper bound
        lower = np.asarray([c for _, c in top], dtype=np.int64)
        upper = countmin_query(cm, keys).astype(np.int64)
        counts = np.minimum(lower, upper)
        order = np.argsort(-counts, kind="stable")
        keys, counts = keys[order], counts[order]
    else:
        keys = np.asarray([], dtype=hk.dtype)
        counts = np.asarray([], dtype=np.int64)

    distinct = _kmv_estimate(_host(sk.kmv).reshape(-1), kmv_k)
    return TableProfile(n=n, t=t, distinct=distinct, heavy_keys=keys,
                        heavy_counts=counts, countmin=cm)


@dataclasses.dataclass(frozen=True)
class DataProfile:
    """A join pair's profile: both tables + cross statistics."""
    s: TableProfile
    t: TableProfile
    est_join_size: float       # CountMin inner product min_d <S_d, T_d>
    heavy_keys: np.ndarray     # union of both tables' heavy keys
    heavy_products: np.ndarray  # est count in S x est count in T, per key

    @property
    def max_heavy_product(self) -> float:
        return float(self.heavy_products.max()) if len(self.heavy_products) \
            else 0.0

    @property
    def size_ratio(self) -> float:
        """min(|S|,|T|) / max(|S|,|T|) in [0, 1]."""
        lo, hi = sorted((self.s.n, self.t.n))
        return lo / max(hi, 1)


def _estimate_join_size(cm_s: np.ndarray, cm_t: np.ndarray) -> float:
    """min over rows of the CountMin inner product."""
    return float(np.min(np.sum(cm_s * cm_t, axis=1)))


def build_data_profile(ps: TableProfile, pt: TableProfile) -> DataProfile:
    union = np.unique(np.concatenate([ps.heavy_keys, pt.heavy_keys])) \
        if len(ps.heavy_keys) or len(pt.heavy_keys) \
        else np.asarray([], dtype=np.int32)
    if len(union):
        prod = (countmin_query(ps.countmin, union).astype(np.float64)
                * countmin_query(pt.countmin, union).astype(np.float64))
    else:
        prod = np.asarray([], dtype=np.float64)
    return DataProfile(s=ps, t=pt,
                       est_join_size=_estimate_join_size(ps.countmin,
                                                         pt.countmin),
                       heavy_keys=union, heavy_products=prod)


# ---------------------------------------------------------------------------
# the sketch round on a substrate: every shard in one run, one taped phase
# ---------------------------------------------------------------------------

SKETCH_PHASE = "round0 sketch"


def _sketch_body(*shards, t_total: int, masked, sample, tape):
    """Sketch each table's shards; one round, each machine shipping its
    sketches and receiving all t machines'."""
    size = len(shards) * sketch_size()
    with tape.phase(SKETCH_PHASE):
        out = tuple(shard_sketch(x, masked=masked, sample=sample)
                    for x in shards)
        tape.record(sent=size, received=size * t_total)
    return out


def sketch_table(x_shards: torch.Tensor, substrate, *, masked=None,
                 sample: Optional[int] = SKETCH_SAMPLE):
    """Sketch a (t, m) sharded table on the substrate.

    Returns ``(TableProfile, tape)`` -- the tape carries the sketch
    phase.  ``sample=None`` disables the per-shard subsampling cap."""
    (sk,), tape = substrate.run(
        functools.partial(_sketch_body, t_total=substrate.t, masked=masked,
                          sample=sample), x_shards)
    return merge_shard_sketches(sk), tape


def profile_sorted_shards(x: torch.Tensor, substrate, *,
                          sample: Optional[int] = SKETCH_SAMPLE):
    """Profile a dense (t, m) sort input.  Returns (TableProfile, tape)."""
    return sketch_table(x, substrate, sample=sample)


def expert_counts_estimate(profile: TableProfile,
                           num_experts: int) -> np.ndarray:
    """Estimated assignments an expert from a routing-id profile.

    The expert ids' domain is tiny ([0, E)), so the whole histogram is a
    CountMin point-query sweep -- an upper bound, inflated by colliding
    mass -- refined by the Misra-Gries heavy hitters wherever one of
    the top keys is that expert (``min`` of the two, as the profile's
    merge refines them).  The sweep is rescaled so the total matches the
    exact assignment count ``profile.n``: ``plan_slots`` reads only
    ratios, but the capacity test reads absolute loads.
    """
    keys = np.arange(num_experts, dtype=np.int32)
    est = countmin_query(profile.countmin, keys).astype(np.float64)
    for key, cnt in zip(np.asarray(profile.heavy_keys).astype(np.int64),
                        np.asarray(profile.heavy_counts, np.float64)):
        if 0 <= key < num_experts:
            est[key] = min(est[key], cnt) if est[key] > 0 else cnt
    total = est.sum()
    if total > 0 and profile.n > 0:
        est = est * (profile.n / total)
    return np.maximum(est, 0.0)


def _deal(keys: torch.Tensor, t: int, masked) -> torch.Tensor:
    """Keys dealt to t shards in contiguous blocks, the last padded."""
    pad = (-keys.numel()) % t
    return torch.cat([keys, keys.new_full((pad,), masked)]).reshape(t, -1)


def profile_join_tables(s_keys, t_keys, t_machines: int, substrate, *,
                        masked, sample: Optional[int] = SKETCH_SAMPLE,
                        device=None):
    """Profile both join tables in one substrate run (one sketch round).

    Keys are int32 host arrays or tensors, moved to ``device`` (None: the
    card, ``device.resolve_device``) once and dealt to the machines
    there.  Returns ``(DataProfile, tape)``."""
    device = resolve_device(device)
    ss = _deal(torch.as_tensor(s_keys).to(device), t_machines, masked)
    ts = _deal(torch.as_tensor(t_keys).to(device), t_machines, masked)
    (sk_s, sk_t), tape = substrate.run(
        functools.partial(_sketch_body, t_total=substrate.t, masked=masked,
                          sample=sample), ss, ts)
    profile = build_data_profile(merge_shard_sketches(sk_s),
                                 merge_shard_sketches(sk_t))
    return profile, tape
