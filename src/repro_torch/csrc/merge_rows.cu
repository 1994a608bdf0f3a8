// Merge of t sorted rows into one sorted row, per batch entry: keys alone
// (merge_rows_*), or (key, int32 id) pairs in lexicographic order, the
// ids being each key's flat index (merge_rows_kv_*: the stable flat
// argsort).  The operand is the landed (batch, t, c) rows as they are,
// contiguous, any t and c; the outputs are (batch, t*c).
//
// Replaces: src/repro/kernels/bitonic.py merge_sorted_rows (:335) and
// merge_sorted_rows_argsort (:351) via _merge_levels (:297, pallas_call
// at :313 keys and :321 argsort, bodies _merge_kernel ->
// merge_network_block :146 and _merge_kv_kernel :183).  The reference
// pads the rows to (tp2, cp2), powers of two, with the sort sentinel
// (_pad_sorted_rows :262), gives the argsort variant the unique id
// channel of _pad_iota_unique (:274: row*c + col on a real slot,
// t*c + row*cp2 + col on a pad), and runs log2(tp2) levels lvl = cp2,
// 2 cp2, ...: the flip of adjacent runs (the second one reversed), then
// the ascending half-cleaner cascade at distances lvl/2, ..., 1.  The
// reference groups levels into row-group blocks; that does not change
// the compare-exchanges an element sees.  This kernel runs the same
// network level for level, so it equals the plain version in
// repro_torch/kernels/bitonic.py bitwise, the keys-only output of +-0
// and of NaN bit patterns included (NaN keys sort past the sentinel and
// land where the network puts them).
//
// The padding, the ids and the output slice happen inside the kernel:
// slot s = row*cp2 + col of an entry is loaded as x[row*c + col] where
// row < t and col < c, as the sentinel otherwise, and only the merged
// positions [0, t*c) are written, which is what the reference's [:n]
// slice keeps.  No padded copy exists in device memory.
//
// What bounds it on the H100.  The work is tiny (the small
// configuration's entry is 8 x 1077 keys, 16,384 padded slots, ~40
// dependent substages) and the bytes are nothing, so the time is the
// chain of synchronisations and the compare-exchange arithmetic of the
// few blocks there are.  Three things shape the kernel.  (1) The
// cascade runs as rounds of four substages in registers: a thread loads
// a group of 16 slots closed under four consecutive distances, runs the
// 32 compare-exchanges and stores them back, one __syncthreads() where
// the substages had four; the tile is XOR-swizzled so that a warp's
// loads of a round hit 32 banks.  (2) One block an entry would leave 124
// of 132 SMs idle at batch 8, so an entry of 8,192 slots or more is split
// over a cluster of up to 8 CTAs (4,096 slots or more each): the levels
// whose blocks fit a CTA run there, and a larger level's flip and its
// substages at distances a CTA's slice or more read the other CTAs'
// slots through distributed shared memory between two cluster barriers.
// (3) A cluster holds up to 8 x 8,192 slots in shared memory, every
// entry up to MAX_KERNEL_LANES, so each call the dispatch makes is one
// launch that reads the rows once and writes the result once.  Past that
// reach (direct calls only) the levels whose runs fit a block still run
// in one tile launch, which reads the unpadded rows; each larger level
// is a global flip, a global pass a cascade distance of a tile or more,
// and a tile launch for the rest of the cascade, over a padded scratch
// the wrapper allocates uninitialised; the last tile launch writes only
// the real positions.
//
// Keys are float32, int32 or bf16 (moved as bf16, compared as float32:
// network.cuh cmp_key).
#include "network.cuh"

#include <cooperative_groups.h>

#include <climits>

using namespace repro;
namespace cg = cooperative_groups;

namespace {

// threads a block (128 registers a thread: a round holds 16 pairs)
constexpr int kThreads = 512;
// the shared memory one block may take on the H100 (232,448 bytes)
constexpr long long kMaxSmem = 227 * 1024;
// global loads a thread keeps in flight while it fills its tile
constexpr int kLoadBatch = 8;
// A padded entry of up to 2^(kLogMaxCluster + kLogCta) slots is merged
// by one launch: by one block below 2 kClusterSlice slots, else by a
// cluster of up to 2^kLogMaxCluster CTAs of at least kClusterSlice slots
// each, which a CTA runs kSlice a thread.  Past that reach (2^16 slots:
// every entry the dispatch hands this kernel) the global passes take the
// top levels.
constexpr int kClusterSlice = 4096;
constexpr int kLogMaxCluster = 3;            // 8 CTAs, the portable most
constexpr int kSlice = 16;
constexpr int kLogCta = 13;                  // kThreads * kSlice slots

template <typename T, bool KV>
constexpr long long slot_bytes() {
  return sizeof(T) + (KV ? sizeof(int) : 0);
}

// Lanes of the largest power-of-two tile a block holds in shared memory.
template <typename T, bool KV>
constexpr int log_tile_max() {
  int l = 0;
  while ((2LL << l) * slot_bytes<T, KV>() <= kMaxSmem) ++l;
  return l;
}

// Lanes of the largest padded entry one launch merges in shared memory.
template <typename T, bool KV>
constexpr int log_launch_max() {
  return (log_tile_max<T, KV>() < kLogCta ? log_tile_max<T, KV>() : kLogCta)
         + kLogMaxCluster;
}

// Where an entry's rows are and what a merge call writes.
struct Rows {
  long long t, c, n;   // landed rows, n = t * c real keys an entry
  int log_cp2;         // a padded row holds 2^log_cp2 slots
  int log_total;       // a padded entry holds 2^log_total slots
};

// Shared-memory address of slot i of a tile: the low 5 bits of the bank
// word XORed with bits 4-8 of the slot, a permutation of every
// power-of-two tile under which a warp's accesses in the rounds below
// (strides 1, 16 and >= 32) and in the loads, stores and flips of
// large levels hit 32 distinct banks.  Keys of 2 bytes swizzle their
// 4-byte words.
template <typename T>
__device__ __forceinline__ int swz(int i) {
  if constexpr (sizeof(T) == 2)
    return i ^ (((i >> 4) & 31) << 1);
  else
    return i ^ ((i >> 4) & 31);
}

// Ascending compare-exchange of (a, b), keys alone or (key, id) pairs.
template <typename T, bool KV>
__device__ __forceinline__ void exchange(T& a, int& va, T& b, int& vb) {
  bool swap;
  if constexpr (KV)
    swap = gt_kv(a, va, b, vb);
  else
    swap = gt(a, b);
  const T k = swap ? b : a;
  b = swap ? a : b;
  a = k;
  if constexpr (KV) {
    const int v = swap ? vb : va;
    vb = swap ? va : vb;
    va = v;
  }
}

// R consecutive substages of the ascending cascade, distances
// 2^(log_e + R - 1), ..., 2^log_e, in registers: a group of 2^R slots
// base + u * 2^log_e is closed under them, so each thread loads its
// groups, runs the R substages on them and stores them back, with one
// __syncthreads() where the substage-by-substage network has R.  The
// compare-exchanges and their order for each slot are the substages'.
template <typename T, bool KV, int R>
__device__ void cascade_round(T* s, int* si, int tile, int log_e) {
  constexpr int G = 1 << R;
  for (int j = threadIdx.x; j < (tile >> R); j += blockDim.x) {
    const int base = ((j >> log_e) << (log_e + R)) | (j & ((1 << log_e) - 1));
    T k[G];
    int v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      k[u] = s[swz<T>(base + (u << log_e))];
      if constexpr (KV) v[u] = si[swz<int>(base + (u << log_e))];
    }
#pragma unroll
    for (int sub = R - 1; sub >= 0; --sub)
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (!(u & (1 << sub)))
          exchange<T, KV>(k[u], v[u], k[u | (1 << sub)], v[u | (1 << sub)]);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      s[swz<T>(base + (u << log_e))] = k[u];
      if constexpr (KV) si[swz<int>(base + (u << log_e))] = v[u];
    }
  }
  __syncthreads();
}

// The ascending cascade at distances 2^log_top, ..., 1 over a tile in
// shared memory, as rounds of 4 substages (strides 1, 16, 256, ...)
// under a top round of what is left.
template <typename T, bool KV>
__device__ void cascade(T* s, int* si, int tile, int log_top) {
  int left = log_top + 1;                     // substages to run
  int r = left % 4 == 0 ? 4 : left % 4;
  while (left > 0) {
    const int log_e = left - r;
    switch (r) {
      case 1: cascade_round<T, KV, 1>(s, si, tile, log_e); break;
      case 2: cascade_round<T, KV, 2>(s, si, tile, log_e); break;
      case 3: cascade_round<T, KV, 3>(s, si, tile, log_e); break;
      default: cascade_round<T, KV, 4>(s, si, tile, log_e); break;
    }
    left -= r;
    r = 4;
  }
}

// The flip of level 2^log_lvl over a tile of 4 * quarter slots: pair i
// of each 2 lvl-block compares (a[i], b[lvl-1-i]) and writes lo to i and
// hi to lvl + i, where the reference's reversed layout puts them.  One
// thread takes pairs i and lvl-1-i, which read and write the same four
// slots, so the flip runs in place with no other thread on them.
template <typename T, bool KV>
__device__ void flip(T* s, int* si, int quarter, int log_lvl) {
  const int lvl = 1 << log_lvl;
  const int lh = log_lvl - 1;
  for (int q = threadIdx.x; q < quarter; q += blockDim.x) {
    const int i = q & ((1 << lh) - 1);
    const int off = (q >> lh) << (log_lvl + 1);
    const int at[4] = {off + i, off + 2 * lvl - 1 - i, off + lvl - 1 - i,
                       off + lvl + i};
    T k[4];
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      k[u] = s[swz<T>(at[u])];
      if constexpr (KV) v[u] = si[swz<int>(at[u])];
    }
    // pair i: (at[0], at[1]) -> lo at[0], hi at[3];
    // pair lvl-1-i: (at[2], at[3]) -> lo at[2], hi at[1]
    exchange<T, KV>(k[0], v[0], k[1], v[1]);
    exchange<T, KV>(k[2], v[2], k[3], v[3]);
    s[swz<T>(at[0])] = k[0];
    s[swz<T>(at[3])] = k[1];
    s[swz<T>(at[2])] = k[2];
    s[swz<T>(at[1])] = k[3];
    if constexpr (KV) {
      si[swz<int>(at[0])] = v[0];
      si[swz<int>(at[3])] = v[1];
      si[swz<int>(at[2])] = v[2];
      si[swz<int>(at[1])] = v[3];
    }
  }
  __syncthreads();
}

// Slots [base, base + count) of an entry's padded sequence into shared
// memory: from the landed rows (from_rows: slot row*cp2 + col holds
// x[row*c + col] and id row*c + col where row < t and col < c, the
// sentinel and id n + slot otherwise) or from the padded scratch.  Each
// thread keeps kLoadBatch global loads in flight.
template <typename T, bool KV>
__device__ void load_slots(const T* __restrict__ x, const T* sk,
                           const int* sv, T* s, int* si, const Rows& r,
                           long long entry, long long base, int count,
                           bool from_rows) {
  const long long cp2 = 1LL << r.log_cp2;
  const long long padded = entry << r.log_total;
  for (int i0 = threadIdx.x; i0 < count; i0 += kLoadBatch * blockDim.x) {
    T key[kLoadBatch];
    int id[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const long long slot = base + (i < count ? i : 0);
      if (from_rows) {
        const long long row = slot >> r.log_cp2, col = slot & (cp2 - 1);
        const bool real = row < r.t && col < r.c;
        key[u] = real ? x[entry * r.n + row * r.c + col] : sentinel<T>();
        id[u] = static_cast<int>(real ? row * r.c + col : r.n + slot);
      } else {
        key[u] = sk[padded + slot];
        if constexpr (KV) id[u] = sv[padded + slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) {
        s[swz<T>(i)] = key[u];
        if constexpr (KV) si[swz<int>(i)] = id[u];
      }
    }
  }
}

// Slots [base, base + count) from shared memory to the merged entry's
// real positions (slot < n; to_out) or to the padded scratch.
template <typename T, bool KV>
__device__ void store_slots(const T* s, const int* si, T* sk, int* sv,
                            T* ok, int* ov, const Rows& r, long long entry,
                            long long base, int count, bool to_out) {
  const long long padded = entry << r.log_total;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const long long slot = base + i;
    if (to_out) {
      if (slot < r.n) {
        ok[entry * r.n + slot] = s[swz<T>(i)];
        if constexpr (KV) ov[entry * r.n + slot] = si[swz<int>(i)];
      }
    } else {
      sk[padded + slot] = s[swz<T>(i)];
      if constexpr (KV) sv[padded + slot] = si[swz<int>(i)];
    }
  }
}

// One tile of 2^log_tile slots of an entry's padded sequence, in shared
// memory.  It loads its slots from the landed rows or from the padded
// scratch; runs either every level lvl = 2^log_cp2, ... whose blocks fit
// the tile, or (cascade_only) the cascade from half a tile down that
// finishes a level the global passes began; and stores to the scratch
// or (to_out) the real positions of the merged entry.
template <typename T, bool KV>
__global__ void __launch_bounds__(kThreads)
    tile_merge(const T* __restrict__ x, T* sk, int* sv, T* ok, int* ov,
               Rows r, int log_tile, bool from_rows, bool cascade_only,
               bool to_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log_tile;
  int* si = reinterpret_cast<int*>(s + tile);
  const int log_tiles = r.log_total - log_tile;     // tiles an entry
  const long long entry = blockIdx.x >> log_tiles;
  const long long base = (long long)(blockIdx.x & ((1 << log_tiles) - 1))
                         << log_tile;                // first slot
  load_slots<T, KV>(x, sk, sv, s, si, r, entry, base, tile, from_rows);
  __syncthreads();
  if (cascade_only) {
    cascade<T, KV>(s, si, tile, log_tile - 1);
  } else {
    for (int ll = r.log_cp2; ll < log_tile; ++ll) {
      flip<T, KV>(s, si, tile / 4, ll);       // ll >= 1: cp2 >= 2
      cascade<T, KV>(s, si, tile, ll - 1);
    }
  }
  store_slots<T, KV>(s, si, sk, sv, ok, ov, r, entry, base, tile, to_out);
}

// Key and id of slot p of an entry held by a cluster: CTA p / L, its
// slot p % L, in that CTA's shared memory (this CTA's own or another's).
template <typename T, bool KV>
__device__ __forceinline__ void cluster_slot(cg::cluster_group& cluster,
                                             T* s, int* si, int p, int log_l,
                                             T& k, int& v) {
  const unsigned rank = static_cast<unsigned>(p >> log_l);
  const int i = p & ((1 << log_l) - 1);
  k = cluster.map_shared_rank(s, rank)[swz<T>(i)];
  if constexpr (KV) v = cluster.map_shared_rank(si, rank)[swz<int>(i)];
}

// One step of a level across the CTAs of a cluster, for the kSlice
// slots each thread holds (L = 2^log_l slots a CTA, kSlice * blockDim.x
// of them): the flip of level 2^ll (flip) or the cascade substage at
// distance 2^ll >= L.  Every thread reads the pair each of its slots
// takes its new value from (the flip's pair (i, 2 lvl-1-i) writes lo to
// i and hi to lvl + i; a substage's pair is (p, p ^ d)), then, once every
// CTA has read, writes its own slots.
template <typename T, bool KV>
__device__ void cluster_step(cg::cluster_group& cluster, T* s, int* si,
                             int log_l, int ll, bool is_flip) {
  const int lvl = 1 << ll;
  const int first = static_cast<int>(cluster.block_rank()) << log_l;
  T nk[kSlice];
  int nv[kSlice];
  cluster.sync();                  // every CTA's previous writes are done
#pragma unroll
  for (int u = 0; u < kSlice; ++u) {
    const int p = first + threadIdx.x + u * blockDim.x;
    int pa, pb;
    bool low;                      // p takes the pair's lo
    if (is_flip) {
      const int b0 = p & ~(2 * lvl - 1), rr = p - b0;
      low = rr < lvl;
      const int i = low ? rr : rr - lvl;
      pa = b0 + i;
      pb = b0 + 2 * lvl - 1 - i;
    } else {
      low = (p & lvl) == 0;
      pa = low ? p : p - lvl;
      pb = pa + lvl;
    }
    T a, b;
    int va = 0, vb = 0;
    cluster_slot<T, KV>(cluster, s, si, pa, log_l, a, va);
    cluster_slot<T, KV>(cluster, s, si, pb, log_l, b, vb);
    exchange<T, KV>(a, va, b, vb);
    nk[u] = low ? a : b;
    nv[u] = low ? va : vb;
  }
  cluster.sync();                  // every CTA has read what it needs
#pragma unroll
  for (int u = 0; u < kSlice; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    s[swz<T>(i)] = nk[u];
    if constexpr (KV) si[swz<int>(i)] = nv[u];
  }
  __syncthreads();
}

// An entry's whole padded sequence (2^log_total slots) merged by a
// cluster of 2^(log_total - log_l) CTAs, L = 2^log_l slots each in
// shared memory: the levels whose blocks fit a CTA run there as in
// tile_merge; a larger level's flip and its cascade substages at
// distances >= L read the other CTAs' slots through distributed shared
// memory (cluster_step), and its cascade below L runs in each CTA.  The
// network is tile_merge's, slot for slot.
template <typename T, bool KV>
__global__ void __launch_bounds__(kThreads)
    cluster_merge(const T* __restrict__ x, T* ok, int* ov, Rows r,
                  int log_l) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int L = 1 << log_l;
  T* s = reinterpret_cast<T*>(smem_raw);
  int* si = reinterpret_cast<int*>(s + L);
  const long long entry = blockIdx.x >> (r.log_total - log_l);
  const long long base = static_cast<long long>(cluster.block_rank())
                         << log_l;
  load_slots<T, KV>(x, nullptr, nullptr, s, si, r, entry, base, L, true);
  __syncthreads();
  for (int ll = r.log_cp2; ll < r.log_total; ++ll) {
    if (ll < log_l) {
      flip<T, KV>(s, si, L / 4, ll);
      cascade<T, KV>(s, si, L, ll - 1);
    } else {
      cluster_step<T, KV>(cluster, s, si, log_l, ll, true);
      for (int ld = ll - 1; ld >= log_l; --ld)
        cluster_step<T, KV>(cluster, s, si, log_l, ld, false);
      cascade<T, KV>(s, si, L, log_l - 1);
    }
  }
  store_slots<T, KV>(s, si, nullptr, nullptr, ok, ov, r, entry, base, L,
                     true);
  cluster.sync();                  // no CTA leaves while others read it
}

// The flip of one level with lvl >= tile, in place over the scratch.
// Thread (block, i), i < lvl/2, owns pairs i and lvl-1-i: together they
// read and write the same four slots, so no other thread touches them.
template <typename T, bool KV>
__global__ void global_flip(T* x, int* v, long long n_threads,
                            long long lvl) {
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= n_threads) return;
  const long long per_block = lvl / 2;
  const long long off = (q / per_block) * 2 * lvl;
  T* y = x + off;
  int* w = KV ? v + off : v;
  const long long i = q % per_block, i2 = lvl - 1 - i;
  // Read all four slots before writing any of them.
  const T a1 = y[i], b1 = y[2 * lvl - 1 - i];
  const T a2 = y[i2], b2 = y[lvl + i];
  int va1 = 0, vb1 = 0, va2 = 0, vb2 = 0;
  if constexpr (KV) {
    va1 = w[i]; vb1 = w[2 * lvl - 1 - i];
    va2 = w[i2]; vb2 = w[lvl + i];
  }
  const bool s1 = KV ? gt_kv(a1, va1, b1, vb1) : gt(a1, b1);
  const bool s2 = KV ? gt_kv(a2, va2, b2, vb2) : gt(a2, b2);
  y[i] = s1 ? b1 : a1;
  y[lvl + i] = s1 ? a1 : b1;
  y[i2] = s2 ? b2 : a2;
  y[lvl + i2] = s2 ? a2 : b2;
  if constexpr (KV) {
    w[i] = s1 ? vb1 : va1;
    w[lvl + i] = s1 ? va1 : vb1;
    w[i2] = s2 ? vb2 : va2;
    w[lvl + i2] = s2 ? va2 : vb2;
  }
}

// One launch of cluster_merge over the batch: clusters of 2^log_cs CTAs.
template <typename T, bool KV>
int launch_cluster(const T* x, T* ok, int* ov, const Rows& r,
                   long long batch, int log_cs, cudaStream_t stream) {
  const int log_l = r.log_total - log_cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch << log_cs));
  cfg.blockDim = dim3((1 << log_l) / kSlice);
  cfg.dynamicSmemBytes = slot_bytes<T, KV>() << log_l;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_merge<T, KV>, x,
                                             ok, ov, r, log_l);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, bool KV>
int launch_tile(const T* x, T* sk, int* sv, T* ok, int* ov, const Rows& r,
                long long batch, int log_tile, bool from_rows,
                bool cascade_only, bool to_out, cudaStream_t stream) {
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < 32 ? 32
                      : (tile / 2 < kThreads ? tile / 2 : kThreads);
  const long long blocks = batch << (r.log_total - log_tile);
  tile_merge<T, KV><<<blocks, threads, tile * slot_bytes<T, KV>(), stream>>>(
      x, sk, sv, ok, ov, r, log_tile, from_rows, cascade_only, to_out);
  return static_cast<int>(cudaGetLastError());
}

// x: (batch, t, c) landed rows; ok (and ov): (batch, t*c) outputs; sk
// (and sv): (batch, tp2*cp2) scratch, needed (and read) only when the
// padded entry exceeds merge_rows_launch_lanes.
template <typename T, bool KV>
int merge_rows(const T* x, T* ok, int* ov, T* sk, int* sv, long long batch,
               long long t, long long c, cudaStream_t stream) {
  if (batch <= 0 || t <= 0 || c <= 0)
    return static_cast<int>(cudaGetLastError());
  // once per process and instantiation: allow the largest tile
  static const cudaError_t configured = cudaFuncSetAttribute(
      tile_merge<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(slot_bytes<T, KV>() << log_tile_max<T, KV>()));
  static const cudaError_t configured_cluster = cudaFuncSetAttribute(
      cluster_merge<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(slot_bytes<T, KV>()
                       << (log_launch_max<T, KV>() - kLogMaxCluster)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (configured_cluster != cudaSuccess)
    return static_cast<int>(configured_cluster);
  Rows r{t, c, t * c, log2_exact(c < 2 ? 2 : c), 0};
  r.log_total = log2_exact(t) + r.log_cp2;
  if (r.n + (1LL << r.log_total) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);   // ids are int32
  const int log_tile = log_tile_max<T, KV>();
  if (r.log_total <= log_launch_max<T, KV>()) {       // one launch
    // CTAs: as many as the entry needs to fit, and up to
    // 2^kLogMaxCluster of at least kClusterSlice slots
    const int log_cta = log_launch_max<T, KV>() - kLogMaxCluster;
    int log_cs = r.log_total > log_cta ? r.log_total - log_cta : 0;
    while (log_cs < kLogMaxCluster &&
           (kClusterSlice << (log_cs + 1)) <= (1 << r.log_total))
      ++log_cs;
    if (log_cs > 0)
      return launch_cluster<T, KV>(x, ok, ov, r, batch, log_cs, stream);
    return launch_tile<T, KV>(x, nullptr, nullptr, ok, ov, r, batch,
                              r.log_total, true, false, true, stream);
  }
  if (sk == nullptr || (KV && sv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = 1LL << r.log_total, tile = 1LL << log_tile;
  const long long first = tile > (1LL << r.log_cp2) ? tile
                                                    : (1LL << r.log_cp2);
  int err = launch_tile<T, KV>(x, sk, sv, ok, ov, r, batch, log_tile, true,
                               false, first >= total, stream);
  const int gthreads = 256;
  const long long pairs = batch * total / 2;
  const long long flips = batch * total / 4;
  for (long long lvl = first; lvl < total && err == 0; lvl *= 2) {
    global_flip<T, KV><<<(flips + gthreads - 1) / gthreads, gthreads, 0,
                         stream>>>(sk, sv, flips, lvl);
    for (long long d = lvl / 2; d >= tile; d /= 2)
      global_substage<T, KV><<<(pairs + gthreads - 1) / gthreads, gthreads, 0,
                               stream>>>(sk, sv, pairs, total, d, 0, false);
    err = launch_tile<T, KV>(x, sk, sv, ok, ov, r, batch, log_tile, false,
                             true, 2 * lvl == total, stream);
  }
  return err;
}

}  // namespace

// Lanes of the largest padded entry one launch merges in shared memory,
// for keys of key_bytes bytes with (kv != 0) or without an id channel:
// a larger entry needs the (batch, tp2*cp2) scratch.
extern "C" long long merge_rows_launch_lanes(int key_bytes, int kv) {
  if (key_bytes == 2)
    return 1LL << (kv ? log_launch_max<__nv_bfloat16, true>()
                      : log_launch_max<__nv_bfloat16, false>());
  return 1LL << (kv ? log_launch_max<float, true>()
                    : log_launch_max<float, false>());
}

#define MERGE_ROWS_ENTRIES(SUFFIX, T)                                        \
  extern "C" int merge_rows_##SUFFIX(const T* x, T* out, T* scratch,         \
                                     long long batch, long long t,           \
                                     long long c, void* stream) {            \
    return merge_rows<T, false>(x, out, nullptr, scratch, nullptr, batch, t, \
                                c, static_cast<cudaStream_t>(stream));       \
  }                                                                          \
  extern "C" int merge_rows_kv_##SUFFIX(                                     \
      const T* x, T* out, int* order, T* scratch, int* scratch_ids,          \
      long long batch, long long t, long long c, void* stream) {             \
    return merge_rows<T, true>(x, out, order, scratch, scratch_ids, batch,   \
                               t, c, static_cast<cudaStream_t>(stream));     \
  }

MERGE_ROWS_ENTRIES(f32, float)
MERGE_ROWS_ENTRIES(i32, int)
MERGE_ROWS_ENTRIES(bf16, __nv_bfloat16)
