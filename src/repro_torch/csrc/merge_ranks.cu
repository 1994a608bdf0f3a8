// Merge of t sorted rows per batch entry: the merged keys and the stable
// flat order, or every pair's global rank.
//
// keys: (batch, t, c), each row increasing in (key, tie); the tie is the
// pair's flat index row * c + col, or its id where ids are given.
// Without ids the merged keys and the flat order (the stable argsort of
// the flattened rows) land in side 0 (k0, s0), (batch, t * c) each.
// With ids (batch, t, c) -- the TPU kernel's contract -- pos[b, i, j]
// gets the number of pairs of batch entry b that are lexicographically
// < (key, id)[b, i, j], its index in the merged order; both sides are
// then scratch.  Keys are float32, int32 or bf16, compared as
// network.cuh cmp_key does (bf16 widened to float32, denormals folded
// to zero: C1).
//
// Replaces: src/repro/kernels/fused.py merge_ranks (:237; pallas_call
// at :272, body _rank_kernel :163, and at :286, body
// _rank_kernel_blocked :209) -- the Round-3 receive merge once the
// padded receive buffer exceeds one tile.
//
// Translation.  The TPU kernel counts, for every query, the pairs below
// it in each of the t bound rows, a binary search per row summed over a
// sequential grid axis: t * log2(c) dependent probes a pair.  Here the
// rows are merged instead, ceil(log2 t) levels of two-way merge path,
// each level a pass that reads and writes every pair once:
//
//   phase A  where it saves a pass over device memory (where g >= 4 rows
//            fit, as at C = 2152): one block takes g rows of one entry
//            into shared memory, merges them there, ceil(log2 g) levels
//            ping-ponging between two buffers, and writes one run out; g
//            is the smallest that needs no more device levels than the
//            largest that fits a block's 227 KB.
//   phase B  the remaining levels over device memory, each merging pairs
//            of runs (an odd run out is carried to the next level);
//            without phase A the first level reads the input rows
//            themselves.  A level is two launches: cut_level finds the
//            co-rank at every tile's start, one thread a tile (a binary
//            search of the two runs); merge_level makes one tile of kTileB
//            outputs a block -- both input slices staged in shared memory
//            by cp.async, each thread merging kItemsB outputs after a
//            binary search for its own co-rank, the tile written out
//            coalesced.
//   output   the last level writes the merged keys and the flat order,
//            or pos[src] = position (the ranks of the ids' contract).
//
// The work is the same whatever the keys' skew: every level moves every
// pair once.  Ranks are additive over column blocks, so the reference's
// bound-row blocking (RANK_MERGE_BOUND_BLOCK) has nothing to say here;
// the wrapper accepts it and ignores it.
//
// What bounds it on the H100: device-memory traffic -- ceil(log2(t / g))
// passes (one more with phase A), each reading and writing sizeof(T) + 4
// bytes a pair (+ 4 with ids) -- and each level's cut search, ~17
// dependent loads (PERF.md has the times).  Tried and no faster:
// merging in place in shared memory (twice the rows a block, one block
// an SM), a 32- or 8-lane cut search (more scattered traffic), a
// two-block cluster merging through distributed shared memory (remote
// loads on the merge's dependent chain), other tile shapes, the batch
// as two halves on two streams (they compete rather than overlap).
// Positions are int32: a batch entry holds fewer than 2^31 pairs.
//
// NaN keys (ROADMAP C15).  The merged order above is the reference's
// only where every row's (key, id) pairs increase.  A NaN compares false
// both ways, so on an entry whose keys hold one the reference's searches
// are not monotone: its ranks collide, and the blocked sums
// (RANK_MERGE_BOUND_BLOCK) differ from the whole-row search.  The
// reference ranks the entry padded to (pow2 t, pow2 c) -- sentinel keys,
// pad ids t*c + row*cp2 + col -- and scatters keys and ids into zeros:
// where ranks collide the last source in flat order wins, a rank past
// the buffer is dropped, a place no rank names keeps key 0 and id 0.
// The merge kernels' first pass flags the entries whose keys hold a NaN
// (flags zeroed first, one atomicOr a warp at most): phase A scans the
// keys it stages, the first device level the keys of its tiles, and the
// t == 1 copy each key it copies.  The tiles follow cuts, which a NaN
// can make inconsistent; each tile's slices are clamped into its runs,
// so that the merge stays in bounds, and a clamped tile flags its entry
// too: where no tile is clamped the tiles stage every key once.  A
// second entry, merge_ranks_replay_*, then replays the reference on the
// flagged entries: one thread a (padded) pair, its rank the sum over
// the bound rows, and over each row's column blocks, of the reference's
// fixed-step search (four searches interleaved a thread, pads generated
// rather than read); with ids the ranks go to pos, without them an
// atomicMax of the source's flat index into the order buffer (set to -1
// first) picks the last writer, and a last pass writes the winners' keys
// and ids, or zeros.  Routing is on the card, with no host sync: the
// replay is one cooperative launch of a co-resident grid whose blocks
// all read the flags first, so on a call with no NaN the whole grid
// returns at once; otherwise its three passes are parted by grid
// barriers (a counter kept after the flags), and each lists the flagged
// entries the same way in every block.  Int32 keys hold no NaN and
// never launch it.  The replay's
// work is t * (cp2 / block) * steps probes a pair, milliseconds at
// SMMS's (64, 64, 4096) padded entry: it runs on the NaN entries alone.
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kThreadsA = 1024;           // phase A: threads a block
constexpr int kThreadsB = 256;            // phase B: threads a block
constexpr int kItemsB = 9;                // outputs a phase-B thread merges
constexpr int kTileB = kThreadsB * kItemsB;
constexpr long long kSmemBytes = 227 * 1024;  // a block's limit on sm_90

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// One side of the ping-pong: keys, flat source indices and (kIds) ids.
template <typename T, bool kIds>
struct Side {
  T* k;
  int* src;
  int* id;

  // shared-memory bytes of a side holding n pairs
  __host__ __device__ static constexpr long long bytes(long long n) {
    return align16(n * (long long)sizeof(T)) + align16(n * 4) +
           (kIds ? align16(n * 4) : 0);
  }
  __device__ static Side carve(unsigned char* p, long long n) {
    Side s;
    s.k = reinterpret_cast<T*>(p);
    s.src = reinterpret_cast<int*>(p + align16(n * (long long)sizeof(T)));
    s.id = kIds ? s.src + align16(n * 4) / 4 : nullptr;
    return s;
  }
  __device__ Side at(long long off) const {
    return {k + off, src ? src + off : nullptr, kIds ? id + off : nullptr};
  }
  // what ties between equal keys break on
  __device__ int tie(long long x) const {
    if constexpr (kIds) return id[x];
    else return src[x];
  }
  __device__ void put(long long x, T key, int s, int i) const {
    k[x] = key;
    src[x] = s;
    if constexpr (kIds) id[x] = i;
  }
  __device__ void copy(long long x, const Side& from, long long y) const {
    put(x, from.k[y], from.src[y], kIds ? from.id[y] : 0);
  }
};

// dst[e] = src[e] for e = threadIdx.x + k * kStride < n, into shared
// memory without waiting: 4-byte elements by cp.async (completed by
// staged()), 2-byte ones eight at a time through registers, so a
// thread keeps many loads in flight either way.
template <int kStride, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < n; e += kStride) {
      const unsigned d =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + e));
    }
  } else {
    for (int e0 = threadIdx.x; e0 < n; e0 += 8 * kStride) {
      T v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (e0 + q * kStride < n) v[q] = src[e0 + q * kStride];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (e0 + q * kStride < n) dst[e0 + q * kStride] = v[q];
    }
  }
}

// The block's stage() copies have landed and are visible to it.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Whether a key is NaN (int32 keys never are).
__device__ __forceinline__ bool is_nan_key(float v) {
  return (__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u;
}
__device__ __forceinline__ bool is_nan_key(__nv_bfloat16 v) {
  return (__bfloat16_as_ushort(v) & 0x7fffu) > 0x7f80u;
}
__device__ __forceinline__ bool is_nan_key(int) { return false; }

// Sets entry's NaN flag where any lane of the warp saw a NaN key: one
// atomicOr a warp at most.  Every lane of a full warp calls it.
__device__ __forceinline__ void flag_nan(int* flags, long long entry,
                                         bool nan) {
  if (__any_sync(0xffffffffu, nan) && (threadIdx.x & 31) == 0)
    atomicOr(&flags[entry], 1);
}

// (ka, ta) < (kb, tb) lexicographically, keys compared as cmp_key does.
template <typename T>
__device__ __forceinline__ bool pair_less(T ka, int ta, T kb, int tb) {
  const cmp_t<T> a = cmp_key(ka), b = cmp_key(kb);
  return a < b || (a == b && ta < tb);
}

// Rows of the input as a run of the first level, without ids: a pair's
// tie is its flat index, origin + its place in the run.
template <typename T>
struct InputRun {
  const T* k;
  long long origin;
  __device__ int tie(long long x) const {
    return static_cast<int>(origin + x);
  }
};

// The number of a's pairs among the first d of merge(a, b): the least
// i with a[i] > b[d - 1 - i] (pairs are unique, so never equal).  R is
// a Side or an InputRun.
template <typename R>
__device__ int co_rank(const R& a, int la, const R& b, int lb, int d) {
  int lo = d - lb > 0 ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = static_cast<int>((static_cast<unsigned>(lo) + hi) >> 1);
    if (pair_less(a.k[mid], a.tie(mid), b.k[d - 1 - mid], b.tie(d - 1 - mid)))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Outputs [d0, d1) of merge(a, b) into out[d0, d1): a co-rank search,
// then a sequential merge holding both heads in registers.
template <typename T, bool kIds>
__device__ void merge_part(const Side<T, kIds>& a, int la,
                           const Side<T, kIds>& b, int lb, int d0, int d1,
                           const Side<T, kIds>& out) {
  if (d0 >= d1) return;
  int i = co_rank(a, la, b, lb, d0);
  int j = d0 - i;
  T ka{}, kb{};
  int ta = 0, tb = 0;
  if (i < la) ka = a.k[i], ta = a.tie(i);
  if (j < lb) kb = b.k[j], tb = b.tie(j);
  for (int d = d0; d < d1; ++d) {
    if (j >= lb || (i < la && pair_less(ka, ta, kb, tb))) {
      out.put(d, ka, kIds ? a.src[i] : ta, ta);
      if (++i < la) ka = a.k[i], ta = a.tie(i);
    } else {
      out.put(d, kb, kIds ? b.src[j] : tb, tb);
      if (++j < lb) kb = b.k[j], tb = b.tie(j);
    }
  }
}

// Pair e of `from` goes to position o of its entry's level: into the
// next level's side, or (the ids' last level) its rank into pos.
template <typename T, bool kIds>
__device__ __forceinline__ void emit(const Side<T, kIds>& from, long long e,
                                     const Side<T, kIds>& dst, int* pos,
                                     long long base, long long o) {
  if (pos != nullptr)
    pos[base + from.src[e]] = static_cast<int>(o);
  else
    dst.copy(base + o, from, e);
}

// Phase A: g rows of one entry merged in shared memory, ping-ponging
// between two buffers, written out as one run of the level-0 layout
// (entry-major, row-major).
template <typename T, bool kIds>
__global__ void __launch_bounds__(kThreadsA)
merge_groups(const T* keys, const int* ids, Side<T, kIds> dst, int* pos,
             int* flags, int t, int c, int g) {
  using S = Side<T, kIds>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (t + g - 1) / g;
  const long long entry = blockIdx.x / groups;
  const int r0 = static_cast<int>(blockIdx.x % groups) * g;
  const int rows = g < t - r0 ? g : t - r0;
  const int n = rows * c;
  const long long base = entry * t * c;
  S x = S::carve(smem, (long long)g * c);
  S y = S::carve(smem + S::bytes((long long)g * c), (long long)g * c);
  const int first = r0 * c;
  stage<kThreadsA>(x.k, keys + base + first, n);
  if constexpr (kIds) stage<kThreadsA>(x.id, ids + base + first, n);
  for (int e = threadIdx.x; e < n; e += kThreadsA) x.src[e] = first + e;
  staged();
  // the group's keys, every one staged: any NaN flags the entry (the
  // merge below is a permutation only where no key is NaN)
  if (flags != nullptr) {
    bool nan = false;
    for (int e = threadIdx.x; e < n; e += kThreadsA) nan |= is_nan_key(x.k[e]);
    flag_nan(flags, entry, nan);
  }
  // one contiguous span of outputs a thread each level; an odd span
  // keeps the threads' shared-memory writes on distinct banks
  const int span = ((n + kThreadsA - 1) / kThreadsA) | 1;
  for (int runs = rows, len = c; runs > 1; runs = (runs + 1) / 2, len *= 2) {
    const int o1 = min(n, (int)(threadIdx.x + 1) * span);
    for (int o = min(n, (int)threadIdx.x * span); o < o1;) {
      const int ps = o / (2 * len) * (2 * len);   // the pair's start
      const int a1 = min(ps + len, n), b1 = min(ps + 2 * len, n);
      const int stop = min(o1, b1);
      merge_part(x.at(ps), a1 - ps, x.at(a1), b1 - a1, o - ps, stop - ps,
                 y.at(ps));
      o = stop;
    }
    __syncthreads();
    const S swap = x;
    x = y;
    y = swap;
  }
  for (int e = threadIdx.x; e < n; e += kThreadsA)
    emit(x, e, dst, pos, base, first + e);
}

// t == 1: the one row is the merged order; each pair's rank its place.
template <typename T, bool kIds>
__global__ void copy_rows(const T* keys, Side<T, kIds> dst, int* pos,
                          int* flags, long long total, int n) {
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       x < total; x += (long long)gridDim.x * blockDim.x) {
    const int e = static_cast<int>(x % n);
    if (flags != nullptr && is_nan_key(keys[x])) atomicOr(&flags[x / n], 1);
    if (pos != nullptr)
      pos[x] = e;
    else
      dst.put(x, keys[x], e, 0);
  }
}

// Phase B, one level: runs of len pairs (the last one shorter) merged
// two by two, each pair's outputs cut into tiles of kTileB; tile q of
// the level is the q-th of batch * per_entry, entry-major, pair-major.
struct Tile {
  long long base;   // the entry's first pair
  long long ps;     // the pair's first output: its first run's start
  long long a1;     // the first run's end, the second's start
  long long b1;     // the second run's end
  long long o0;     // the tile's first output
  int m;            // the tile's outputs
};

__device__ __forceinline__ Tile tile_of(long long q, int n, long long len,
                                        int per_entry, int tiles_full) {
  Tile tl;
  const long long entry = q / per_entry;
  const int rest = static_cast<int>(q - entry * per_entry);
  tl.base = entry * n;
  tl.ps = (long long)(rest / tiles_full) * 2 * len;
  tl.o0 = tl.ps + (long long)(rest % tiles_full) * kTileB;
  tl.a1 = min(tl.ps + len, (long long)n);
  tl.b1 = min(tl.ps + 2 * len, (long long)n);
  tl.m = static_cast<int>(min((long long)kTileB, tl.b1 - tl.o0));
  return tl;
}

// The co-rank at every tile's start, one thread a tile, so that a
// merging block finds its inputs' slices without a search of its own.
// kInput: the level's runs are the input rows themselves (src.k and
// src.id are the input's; a pair's source index is its place).
template <typename T, bool kIds, bool kInput>
__global__ void cut_level(Side<T, kIds> src, int* cuts, long long count,
                          int n, long long len, int per_entry,
                          int tiles_full) {
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= count) return;
  const Tile tl = tile_of(q, n, len, per_entry, tiles_full);
  const int la = static_cast<int>(tl.a1 - tl.ps);
  const int lb = static_cast<int>(tl.b1 - tl.a1);
  const int d = static_cast<int>(tl.o0 - tl.ps);
  if constexpr (kInput && !kIds)
    cuts[q] = co_rank(InputRun<T>{src.k + tl.base + tl.ps, tl.ps}, la,
                      InputRun<T>{src.k + tl.base + tl.a1, tl.a1}, lb, d);
  else
    cuts[q] = co_rank(src.at(tl.base + tl.ps), la, src.at(tl.base + tl.a1),
                      lb, d);
}

// Tile blockIdx.x of the level: both input slices staged in shared
// memory, kItemsB outputs merged by each thread into a second buffer,
// written out coalesced.
template <typename T, bool kIds, bool kInput>
__global__ void __launch_bounds__(kThreadsB)
merge_level(Side<T, kIds> src, Side<T, kIds> dst, int* pos, const int* cuts,
            int* flags, int n, long long len, int per_entry, int tiles_full) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tl = tile_of(blockIdx.x, n, len, per_entry, tiles_full);
  const Side<T, kIds> a = src.at(tl.base + tl.ps), b = src.at(tl.base + tl.a1);
  const int m = tl.m;
  const int la = static_cast<int>(tl.a1 - tl.ps);
  // the next tile of the same pair starts where this one ends
  const int lb = static_cast<int>(tl.b1 - tl.a1);
  const int i0 = cuts[blockIdx.x];
  const int j0 = static_cast<int>(tl.o0 - tl.ps) - i0;
  // the tile's slice of a, kept inside both runs and the tile: the cuts
  // are monotone only where no key is NaN
  const int na_cut = (tl.o0 + m == tl.b1 ? la : cuts[blockIdx.x + 1]) - i0;
  const int na = min(min(m, la - i0), max(max(0, m - (lb - j0)), na_cut));
  Side<T, kIds> tile = Side<T, kIds>::carve(smem, kTileB);
  Side<T, kIds> out = Side<T, kIds>::carve(
      smem + Side<T, kIds>::bytes(kTileB), kTileB);
  stage<kThreadsB>(tile.k, a.k + i0, na);
  stage<kThreadsB>(tile.k + na, b.k + j0, m - na);
  if constexpr (kInput) {            // a pair's source index: its place
    for (int e = threadIdx.x; e < m; e += kThreadsB)
      tile.src[e] = static_cast<int>(
          e < na ? tl.ps + i0 + e : tl.a1 + j0 + (e - na));
  } else {
    stage<kThreadsB>(tile.src, a.src + i0, na);
    stage<kThreadsB>(tile.src + na, b.src + j0, m - na);
  }
  if constexpr (kIds) {
    stage<kThreadsB>(tile.id, a.id + i0, na);
    stage<kThreadsB>(tile.id + na, b.id + j0, m - na);
  }
  staged();
  // the first level flags the entry: where no tile's slice needed the
  // clamp the tiles cover the input rows once, so a NaN key is staged
  // by some tile; a clamped slice means the cuts are not monotone, which
  // only a NaN key makes them
  if (kInput && flags != nullptr) {
    bool nan = na != na_cut;
    for (int e = threadIdx.x; e < m; e += kThreadsB)
      nan |= is_nan_key(tile.k[e]);
    flag_nan(flags, blockIdx.x / per_entry, nan);
  }
  const int q0 = min(m, (int)threadIdx.x * kItemsB);
  merge_part(tile, na, tile.at(na), m - na, q0, min(m, q0 + kItemsB), out);
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += kThreadsB)
    emit(out, e, dst, pos, tl.base, tl.o0 + e);
}

// Tiles of level r of a merge of `groups` runs of g * c pairs: each
// entry's (pairs - 1) * tiles_full + the last pair's.
struct LevelShape {
  long long len;
  int per_entry;
  int tiles_full;
};

LevelShape level_shape(long long n, long long groups, long long run, int r) {
  const long long len = run << (r - 1);
  const long long runs = (groups + (1LL << (r - 1)) - 1) >> (r - 1);
  const long long pairs = (runs + 1) / 2;
  const long long full = (2 * len + kTileB - 1) / kTileB;
  const long long last = (n - (pairs - 1) * 2 * len + kTileB - 1) / kTileB;
  return {len, static_cast<int>((pairs - 1) * full + last),
          static_cast<int>(full)};
}

int ceil_log2(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

template <typename T, bool kIds>
int merge_rows(const T* keys, const int* ids, Side<T, kIds> side0,
               Side<T, kIds> side1, int* pos, int* cuts, int* flags,
               long long batch, long long t, long long c,
               cudaStream_t stream) {
  using S = Side<T, kIds>;
  const long long n = t * c;
  if (batch < 0 || t < 0 || c < 0 || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (flags != nullptr) {
    err = cudaMemsetAsync(flags, 0, sizeof(int) * (batch + 1), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // g: rows a phase-A block merges; the fewest levels, then the least
  // shared memory.  Phase A runs where it saves a pass over device
  // memory: where it merges 2 (or 3) rows, the first level reads the
  // input rows instead.
  long long g_max = 1;
  while (g_max < t && 2 * S::bytes((g_max + 1) * c) <= kSmemBytes) ++g_max;
  long long g = 1;
  if (g_max >= 2) {
    const int fewest = ceil_log2((t + g_max - 1) / g_max);
    for (g = 2; ceil_log2((t + g - 1) / g) > fewest; ++g) {
    }
    if (1 + ceil_log2((t + g - 1) / g) >= ceil_log2(t)) g = 1;
  }
  const long long groups = (t + g - 1) / g;     // runs of the first level
  const int levels = ceil_log2(groups);
  // level r lives in side 0 when levels - r is even: the last one is side 0
  auto level = [&](int r) { return ((levels - r) & 1) ? side1 : side0; };
  if (t == 1) {
    const long long total = batch * n;
    const long long blocks = (total + 255) / 256 < 8192 ? (total + 255) / 256
                                                        : 8192;
    copy_rows<T, kIds><<<blocks, 256, 0, stream>>>(keys, level(0), pos, flags,
                                                   total, (int)n);
  } else if (g >= 2) {
    const long long smem = 2 * S::bytes(g * c);
    err = cudaFuncSetAttribute(merge_groups<T, kIds>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_groups<T, kIds><<<batch * groups, kThreadsA, smem, stream>>>(
        keys, ids, level(0), levels == 0 ? pos : nullptr, flags, (int)t,
        (int)c, (int)g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem_b = 2 * S::bytes(kTileB);
  for (auto fn : {merge_level<T, kIds, false>, merge_level<T, kIds, true>}) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_b));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // without phase A the first level reads the input rows
  const S input{const_cast<T*>(keys), nullptr, const_cast<int*>(ids)};
  for (int r = 1; r <= levels; ++r) {
    const LevelShape ls = level_shape(n, groups, g * c, r);
    const long long count = batch * ls.per_entry;
    const bool from_input = r == 1 && g == 1;
    const S from = from_input ? input : level(r - 1);
    int* const last = r == levels ? pos : nullptr;
    const auto cut = from_input ? cut_level<T, kIds, true>
                                : cut_level<T, kIds, false>;
    const auto merge = from_input ? merge_level<T, kIds, true>
                                  : merge_level<T, kIds, false>;
    cut<<<(count + 127) / 128, 128, 0, stream>>>(
        from, cuts, count, (int)n, ls.len, ls.per_entry, ls.tiles_full);
    merge<<<count, kThreadsB, smem_b, stream>>>(
        from, level(r), last, cuts, from_input ? flags : nullptr, (int)n,
        ls.len, ls.per_entry, ls.tiles_full);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cuts a call needs: at most ceil(n / kTileB) + pairs tiles an
// entry at any level, pairs <= t.
long long cuts_bound(long long batch, long long t, long long c) {
  return batch * ((t * c + kTileB - 1) / kTileB + t);
}

// ids null: the merged keys and flat order land in (k0, s0) and i0, i1
// and pos are unused; ids given: pos gets the ranks and the sides are
// scratch.  Each side holds (batch, t * c) pairs; cuts holds
// merge_ranks_cuts(batch, t, c) ints; flags (batch,), or null, gets a
// nonzero for each entry whose keys hold a NaN.
template <typename T>
int merge_entry(const T* keys, const int* ids, T* k0, int* s0, int* i0,
                T* k1, int* s1, int* i1, int* pos, int* cuts, int* flags,
                long long batch, long long t, long long c, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (ids == nullptr)
    return merge_rows<T, false>(keys, ids, {k0, s0, nullptr},
                                {k1, s1, nullptr}, nullptr, cuts, flags,
                                batch, t, c, st);
  if (pos == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return merge_rows<T, true>(keys, ids, {k0, s0, i0}, {k1, s1, i1}, pos,
                             cuts, flags, batch, t, c, st);
}

// ---------------------------------------------------------------------------
// The replay of the reference's ranks on the entries whose keys hold a NaN.

constexpr int kReplayThreads = 256;   // threads a replay block
constexpr int kChains = 4;            // searches a thread interleaves

// One batch entry's bound rows as the reference searches them: with ids
// the caller's (t, c) keys and ids; without, the entry padded to (rows,
// width) = (pow2 t, pow2 c), its pads generated: the sort sentinel and
// id t*c + row*width + col.
template <typename T>
struct ReplayRows {
  const T* keys;
  const int* ids;
  int t, c, width;
  __device__ bool real(int r, int j) const { return r < t && j < c; }
  __device__ T raw(int r, int j) const {
    return ids != nullptr || real(r, j) ? keys[(long long)r * c + j]
                                        : sentinel<T>();
  }
  // a pad's id in int32 arithmetic, wrapping as the reference's does
  __device__ int id(int r, int j) const {
    if (ids != nullptr) return ids[(long long)r * c + j];
    return real(r, j) ? r * c + j
                      : static_cast<int>(static_cast<unsigned>(t * c) +
                                         static_cast<unsigned>(r * width + j));
  }
};

// The reference's rank of (qk, qi): the sum over the bound rows and
// over each row's nb column blocks of bb slots of its fixed-step search
// for the pairs < (qk, qi), kChains searches at a time.  Its steps past
// lo == hi change nothing, so a search stops there.
template <typename T>
__device__ int replay_rank(const ReplayRows<T>& rows, int nrows, int bb,
                           int nb, int steps, cmp_t<T> qk, int qi) {
  const int searches = nrows * nb;
  int rank = 0;
  for (int s0 = 0; s0 < searches; s0 += kChains) {
    int lo[kChains], hi[kChains], row[kChains], base[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      const int s = s0 + u;
      row[u] = s / nb;
      base[u] = (s % nb) * bb;
      lo[u] = 0;
      hi[u] = s < searches ? min(bb, rows.width - base[u]) : 0;
    }
    for (int step = 0; step < steps; ++step) {
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        if (lo[u] < hi[u]) {
          const int mid = (lo[u] + hi[u]) >> 1;
          const cmp_t<T> k = cmp_key(rows.raw(row[u], base[u] + mid));
          const bool less =
              k < qk || (k == qk && rows.id(row[u], base[u] + mid) < qi);
          lo[u] = less ? mid + 1 : lo[u];
          hi[u] = less ? hi[u] : mid;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChains; ++u) rank += lo[u];
  }
  return rank;
}

// fn(entry, item) for every item of every flagged entry, items spread
// over the whole grid.  Entries are listed kReplayThreads at a time in
// ascending order, the same list in every block; a window with none
// costs a block one load a thread.
template <typename F>
__device__ void over_flagged(const int* flags, long long batch,
                             long long per_entry, F&& fn) {
  __shared__ int list[kReplayThreads];
  __shared__ int warp_count[kReplayThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e0 = 0; e0 < batch; e0 += kReplayThreads) {
    const long long e = e0 + threadIdx.x;
    const bool flagged = e < batch && flags[e] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, flagged);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, listed = 0;
    for (int w = 0; w < kReplayThreads / 32; ++w) {
      before += w < warp ? warp_count[w] : 0;
      listed += warp_count[w];
    }
    if (flagged)
      list[before + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
    __syncthreads();
    const long long work = listed * per_entry;
    for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         w < work; w += stride) {
      const long long f = w / per_entry;
      fn(e0 + list[f], w - f * per_entry);
    }
    __syncthreads();
  }
}

template <typename T> __device__ __forceinline__ T zero_key();
template <> __device__ __forceinline__ float zero_key<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_key<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Every block of the grid waits here until all have arrived for the
// k-th time (target = k * gridDim.x); the grid is co-resident (a
// cooperative launch) and the counter zero at the launch.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (atomicAdd(counter, 0u) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The replay, one cooperative launch.  Every block first reads all the
// flags, so either the whole grid returns (no entry holds a NaN: the
// clean path's cost) or none does.  With ids: each flagged entry's t*c
// pairs ranked, into pos.  Without: (1) the order of each flagged
// entry's t*c places set to -1; (2) every padded pair (rows x width,
// the pads too) ranked, its flat index atomicMax-ed into order at its
// rank where that is below t*c -- the last source in flat order wins;
// (3) each place gets its winner's key and id, or key 0 and id 0 where
// no pair ranked there.  Grid barriers between the three.
template <typename T>
__global__ void __launch_bounds__(kReplayThreads)
replay(const T* keys, const int* ids, int* flags, T* merged, int* order,
       int* pos, long long batch, int t, int c, int nrows, int width, int bb,
       int nb, int steps) {
  const long long n = (long long)t * c;
  bool any = false;
  for (long long e0 = 0; e0 < batch && !any; e0 += kReplayThreads) {
    const long long e = e0 + threadIdx.x;
    any = __syncthreads_or(e < batch && flags[e] != 0);
  }
  if (!any) return;
  unsigned* barrier = reinterpret_cast<unsigned*>(flags + batch);
  if (ids == nullptr) {
    over_flagged(flags, batch, n,
                 [&](long long e, long long p) { order[e * n + p] = -1; });
    grid_barrier(barrier, gridDim.x);
  }
  over_flagged(flags, batch, (long long)nrows * width,
               [&](long long e, long long q) {
    const ReplayRows<T> rows{keys + e * n, ids ? ids + e * n : nullptr, t, c,
                             width};
    const int r = static_cast<int>(q / width), j = static_cast<int>(q % width);
    const int rank = replay_rank(rows, nrows, bb, nb, steps,
                                 cmp_key(rows.raw(r, j)), rows.id(r, j));
    if (ids != nullptr)
      pos[e * n + q] = rank;
    else if (rank < n)
      atomicMax(&order[e * n + rank], static_cast<int>(q));
  });
  if (ids != nullptr) return;
  grid_barrier(barrier, 2 * gridDim.x);
  over_flagged(flags, batch, n, [&](long long e, long long p) {
    const ReplayRows<T> rows{keys + e * n, nullptr, t, c, width};
    const int w = __ldcg(&order[e * n + p]);
    merged[e * n + p] = w < 0 ? zero_key<T>() : rows.raw(w / width, w % width);
    order[e * n + p] = w < 0 ? 0 : rows.id(w / width, w % width);
  });
  // the last block out leaves the counter at 0 for another call on
  // these flags
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(barrier, 1u) == 3 * gridDim.x - 1)
    atomicExch(barrier, 0u);
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

long long next_pow2(long long v) {
  long long p = 1;
  while (p < v) p <<= 1;
  return p;
}

// flags (batch + 1,) as merge_entry left them: the entries' NaN flags,
// then the replay's grid barrier counter (zero).  ids given: pos (batch, t, c)
// gets the reference's merge_ranks(keys, ids, bound_block) on flagged
// entries; ids null: merged and order (batch, t * c) get its _rank_merge
// there, bound_block being the block it applies (0: whole rows).
template <typename T>
int replay_entry(const T* keys, const int* ids, int* flags, T* merged,
                 int* order, int* pos, long long batch, long long t,
                 long long c, long long bound_block, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n = t * c;
  if (batch < 0 || t < 0 || c < 0 || bound_block < 0 || n >= (1LL << 31) ||
      flags == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const long long nrows = ids != nullptr ? t : next_pow2(t);
  const long long width = ids != nullptr ? c : (c < 2 ? 2 : next_pow2(c));
  const bool outputs = ids != nullptr ? pos != nullptr
                                       : merged != nullptr && order != nullptr;
  if (nrows * width >= (1LL << 31) || !outputs)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bb =
      bound_block > 0 && bound_block < width ? bound_block : width;
  const long long nb = (width + bb - 1) / bb;
  int steps = 0;                  // ceil(log2(bb + 1)): bb's bit length
  while ((bb >> steps) > 0) ++steps;
  // the co-resident grid: as many blocks as fit, asked once per card
  static int per_sm[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (per_sm[dev] == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm[dev], replay<T>, kReplayThreads, 0) != cudaSuccess ||
       per_sm[dev] < 1))
    per_sm[dev] = 1;
  int nrows_i = (int)nrows, width_i = (int)width, bb_i = (int)bb,
      nb_i = (int)nb, t_i = (int)t, c_i = (int)c;
  void* args[] = {(void*)&keys, (void*)&ids,    (void*)&flags,
                  (void*)&merged, (void*)&order, (void*)&pos,
                  (void*)&batch, (void*)&t_i,    (void*)&c_i,
                  (void*)&nrows_i, (void*)&width_i, (void*)&bb_i,
                  (void*)&nb_i,  (void*)&steps};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      replay<T>, dim3(per_sm[dev] * sm_count()),
      dim3(kReplayThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long merge_ranks_cuts(long long batch, long long t,
                                      long long c) {
  return cuts_bound(batch, t, c);
}

#define MERGE_RANKS_ENTRY(suffix, T)                                         \
  extern "C" int merge_ranks_##suffix(                                       \
      const T* keys, const int* ids, T* k0, int* s0, int* i0, T* k1,         \
      int* s1, int* i1, int* pos, int* cuts, int* flags, long long batch,    \
      long long t, long long c, void* stream) {                              \
    return merge_entry(keys, ids, k0, s0, i0, k1, s1, i1, pos, cuts, flags,  \
                       batch, t, c, stream);                                 \
  }

MERGE_RANKS_ENTRY(f32, float)
MERGE_RANKS_ENTRY(i32, int)
MERGE_RANKS_ENTRY(bf16, __nv_bfloat16)

// The NaN replay: float32 and bf16 keys only.
#define MERGE_RANKS_REPLAY_ENTRY(suffix, T)                                  \
  extern "C" int merge_ranks_replay_##suffix(                                \
      const T* keys, const int* ids, int* flags, T* merged,                  \
      int* order, int* pos, long long batch, long long t, long long c,       \
      long long bound_block, void* stream) {                                 \
    return replay_entry(keys, ids, flags, merged, order, pos, batch, t, c,   \
                        bound_block, stream);                                \
  }

MERGE_RANKS_REPLAY_ENTRY(f32, float)
MERGE_RANKS_REPLAY_ENTRY(bf16, __nv_bfloat16)
