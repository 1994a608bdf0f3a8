// The row-wise bitonic sort network, shared by csrc/bitonic_sort.cu (the
// sort) and csrc/sort_partition.cu (the sort fused with the boundary
// search).  Two schedules of the same network, compare-exchange for
// compare-exchange (same pairs, same directions, same swap rule), so
// both give the plain versions' output bitwise.
//
// row_sort (below; every sort, keys alone or (key, value) pairs, on rows
// of up to 2^16 padded slots).  One launch a call.  A row of up to 8,192
// padded slots is one CTA; a row of 2^14-2^16 is a cluster of 2-8 CTAs
// of 8,192 slots each, whose shared memory holds the row (64 KiB a CTA).
// The kernel reads the caller's unpadded row once, makes the pads as it
// loads (the sort sentinel; with pairs, value int32 max, and a generated
// value channel is the column), runs the whole network on chip and
// writes the real positions [0, m) once.
//   * Register rounds.  A thread loads a group of 32 slots closed under
//     five consecutive substages of one stage (16 slots and four in a
//     tile of 4,096 slots or fewer, which so keeps twice the threads),
//     runs them in registers and stores the group back: one barrier
//     where the network has up to five substages.  Stages 0-4 are the
//     first round; each later stage k takes one cluster round for its
//     substages at distances of a CTA's slice or more (its top five
//     substages, read and written through distributed shared memory
//     between two cluster barriers), then rounds of its other substages
//     within the CTA, five-aligned from the bottom: 30 rounds a row at
//     2^16, where the network has 136 substages.  A round whose groups
//     lie in the thread's own warp's slots waits on a warp barrier, not
//     the block's.
//   * Directions.  Stage k's direction is bit k+1 of the slot's
//     position in the row (rank * slice + slot): a 32-bit mask a group.
//   * Banks.  The tile is XOR-swizzled (row_swz) so that no warp access
//     of a round, a load or a store meets a bank conflict
//     (tests/test_torch_pair_sort.py checks every access).
//   * Words.  A row with no NaN key is sorted as one unsigned word a
//     slot (WordSlots, RowKey), so that a compare-exchange is one
//     integer comparison.  Pairs: (key, value) ordered as gt_kv orders
//     them, a 64-bit word, or a 32-bit one for bf16 keys with the order
//     generated.  Keys alone: the 32-bit key integer where no key folds
//     (int32 keys always); where keys fold (+-0, denormals: one integer
//     for the whole class), the key integer over the key's own bits,
//     compared on the key half only, so that keys that compare equal
//     never trade places, as under the network's swap rule (bf16 keys
//     always carry their bits: a 32-bit word).  A row with a NaN key
//     runs the same network on the keys as they are (gt, gt_kv).
//   * Occupancy.  At most 256 threads a CTA at 128 registers: two CTAs
//     an SM, so one's barriers hide behind the other's rounds.
// With SEARCH the kernel then runs the reference's fixed-step search of
// each query over the row's first m sorted keys, each probe read from the
// CTA that holds it, and writes the cut: the reference's search step for
// step, so the cuts are its own for any row, NaN keys included, with no
// memset and no atomics.
//
// tile_stages / global_substage (rows past 2^16 padded slots, direct
// calls only: the dispatch sends such rows to the radix sort).  The usual
// GPU split over a padded scratch: every substage at a distance below
// the tile runs in shared memory on tiles of 2^kLogTile elements (one
// launch for all stages up to log2(tile), then one launch per larger
// stage for its in-tile tail); each substage at a distance of a tile or
// more is one pass over global memory, one thread per pair
// (global_substage, network.cuh).  With KV an int32 value channel moves
// with the keys; its tile follows the keys' tile in shared memory (64
// KiB at 8192 pairs, past the 48 KiB a launch gets by default, so the
// limit is raised once per instantiation).  The search then runs apart
// (search_rows), the reference's fixed-step search over the sorted
// scratch.
#pragma once

#include "network.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace repro {
// Internal linkage: the function-local statics below (the attributes set
// once per instantiation) belong to the kernels of the library that
// includes this header; two libraries loaded into one process would
// otherwise share one guard between their two copies of a kernel.
namespace {

constexpr int kLogTile = 13;          // 8192 elements per shared-memory tile
constexpr int kThreads = 1024;

// Stages k in [k_lo, k_hi], each with its substages j from
// min(k, log_tile - 1) down to 0, on each tile of 2^log_tile
// consecutive elements.  A tile never straddles two rows (it divides
// n); the direction comes from the element's position in its row.
template <typename T, bool KV>
__global__ void tile_stages(T* x, int* v, long long n, int log_tile,
                            int k_lo, int k_hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log_tile;
  int* sv = reinterpret_cast<int*>(s + tile);
  const long long base = (long long)blockIdx.x * tile;
  const long long col0 = base % n;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    s[i] = x[base + i];
    if constexpr (KV) sv[i] = v[base + i];
  }
  __syncthreads();
  const int half = tile / 2;
  for (int k = k_lo; k <= k_hi; ++k) {
    for (int j = min(k, log_tile - 1); j >= 0; --j) {
      const int d = 1 << j;
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int p = ((q >> j) << (j + 1)) | (q & (d - 1));
        const bool desc = (((col0 + p) >> (k + 1)) & 1) != 0;
        compare_exchange_any<T, KV>(s, sv, p, d, desc);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    x[base + i] = s[i];
    if constexpr (KV) v[base + i] = sv[i];
  }
}

// Sort each row of x (and v with KV) in place: rows of n slots, n a
// power of two.
template <typename T, bool KV>
int sort_rows(T* x, int* v, long long rows, long long n,
              cudaStream_t stream) {
  if (rows <= 0 || n < 2) return static_cast<int>(cudaGetLastError());
  if (KV) {
    // once per instantiation: room for the largest tile of pairs
    static const cudaError_t configured = cudaFuncSetAttribute(
        tile_stages<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((1 << kLogTile) * (sizeof(T) + sizeof(int))));
    if (configured != cudaSuccess) return static_cast<int>(configured);
  }
  const int log_n = log2_exact(n);
  const int log_tile = log_n < kLogTile ? log_n : kLogTile;
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const long long blocks = rows * n / tile;
  const size_t smem = tile * (sizeof(T) + (KV ? sizeof(int) : 0));
  tile_stages<T, KV><<<blocks, threads, smem, stream>>>(x, v, n, log_tile, 0,
                                                        log_tile - 1);
  const long long pairs = rows * n / 2;
  const int gthreads = 256;
  const long long gblocks = (pairs + gthreads - 1) / gthreads;
  for (int k = log_tile; k < log_n; ++k) {
    for (int j = k; j >= log_tile; --j)
      global_substage<T, KV><<<gblocks, gthreads, 0, stream>>>(
          x, v, pairs, n, 1LL << j, k, true);
    tile_stages<T, KV><<<blocks, threads, smem, stream>>>(x, v, n, log_tile,
                                                          k, k);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// row_sort: one launch a call, the row in (distributed) shared memory
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kRowLogSlice = 13;       // slots a CTA holds (8,192)
constexpr int kRowLogMaxCluster = 3;   // 8 CTAs a row, the portable most
constexpr int kRowLogLaunch = kRowLogSlice + kRowLogMaxCluster;
constexpr int kRowLogRound = 5;        // a round's group: 32 slots
constexpr int kRowThreads = (1 << kRowLogSlice) >> kRowLogRound;   // 256
// log2 of a round's group in a CTA of 2^log_l slots: 32 slots in a full
// slice, 16 in a smaller tile, which so keeps twice the threads (a row
// of 2,048 is 128 threads, not 64).
__host__ __device__ constexpr int row_log_round(int log_l) {
  return log_l >= kRowLogSlice ? kRowLogRound : 4;
}
// Two CTAs an SM (128 registers a thread): while one waits at a barrier
// the other runs its round.
constexpr int kRowMinBlocks = 2;
constexpr int kRowLoadBatch = 8;       // global loads a thread keeps in flight

using u64 = unsigned long long;

// Bytes of shared memory a CTA of 2^log_l slots takes: 8 a slot, the
// widest slot (a packed pair, or a float32 key over its bits), which also
// holds the exact comparator's key and value arrays.
constexpr size_t row_smem(int log_l) {
  return static_cast<size_t>(sizeof(u64)) << log_l;
}

// A row's launch: m real keys a row, padded to 2^log_total slots, held
// by 2^(log_total - log_l) CTAs of 2^log_l slots.
struct RowLaunch {
  long long m;
  int log_total, log_l;
};

// The integer representations.  A row with no NaN key is sorted as one
// unsigned word a slot whose key part is the key folded as cmp_key folds
// it (a denormal to zero, -0.0 to +0.0: keys that compare equal map to
// one integer) and mapped to an unsigned integer of the same order (to;
// from undoes it for a key that does not fold).  Pairs: the low part is
// the value, so that unsigned order is int32 order and gt_kv one
// unsigned comparison of the words: the network's compare-exchanges with
// cmp_key's outcomes, so the output is the exact comparator's.  Packed: a
// 64-bit word, the value biased by 2^31.  Compact (bf16 keys, values
// generated): a 32-bit word, the 16-bit key over the 16-bit column
// (0xffff on a pad: a row of 2^16 columns has no pad, a shorter one no
// column 0xffff).  A key of the zero class is rebuilt from the caller's
// row at its column, so values given need a row whose keys do not fold.
// Keys alone: the key integer alone where no key folds (gt is then one
// unsigned comparison), else the key integer over the key's own bits
// (bits, of_bits), compared on the key half only.  NaN, which compares
// neither above nor below nor equal to anything, keeps its row on the
// exact comparator (network.cuh gt, gt_kv on the keys as they are).
template <typename T> struct RowKey;
template <> struct RowKey<float> {
  static __device__ __forceinline__ bool nan(float v) {
    return (__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u;
  }
  static __device__ __forceinline__ bool folds(float v) {
    return (__float_as_uint(v) & 0x7f800000u) == 0u;      // +-0, denormals
  }
  static __device__ __forceinline__ uint32_t to(float v) {
    const uint32_t u = folds(v) ? 0u : __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float from(uint32_t t) {
    return __uint_as_float((t & 0x80000000u) ? (t & 0x7fffffffu) : ~t);
  }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float of_bits(uint32_t u) {
    return __uint_as_float(u);
  }
  static constexpr uint32_t kZero = 0x80000000u;          // to(+-0.0)
  static constexpr bool kRebuilt = true;  // kZero is rebuilt from the row
};
template <> struct RowKey<__nv_bfloat16> {
  static __device__ __forceinline__ bool nan(__nv_bfloat16 v) {
    return (__bfloat16_as_ushort(v) & 0x7fffu) > 0x7f80u;
  }
  static __device__ __forceinline__ bool folds(__nv_bfloat16 v) {
    return (__bfloat16_as_ushort(v) & 0x7f80u) == 0u;
  }
  static __device__ __forceinline__ uint32_t to(__nv_bfloat16 v) {
    const uint32_t u = folds(v) ? 0u : __bfloat16_as_ushort(v);
    return (u & 0x8000u) ? (~u & 0xffffu) : (u | 0x8000u);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(uint32_t t) {
    return __ushort_as_bfloat16(static_cast<uint16_t>(
        (t & 0x8000u) ? (t & 0x7fffu) : ~t));
  }
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 of_bits(uint32_t u) {
    return __ushort_as_bfloat16(static_cast<uint16_t>(u));
  }
  static constexpr uint32_t kZero = 0x8000u;
  static constexpr bool kRebuilt = true;
};
template <> struct RowKey<int> {
  static __device__ __forceinline__ bool nan(int) { return false; }
  static __device__ __forceinline__ bool folds(int) { return false; }
  static __device__ __forceinline__ uint32_t to(int v) {
    return static_cast<uint32_t>(v) ^ 0x80000000u;
  }
  static __device__ __forceinline__ int from(uint32_t t) {
    return static_cast<int>(t ^ 0x80000000u);
  }
  static __device__ __forceinline__ uint32_t bits(int v) {
    return static_cast<uint32_t>(v);
  }
  static __device__ __forceinline__ int of_bits(uint32_t u) {
    return static_cast<int>(u);
  }
  static constexpr uint32_t kZero = 0x80000000u;
  static constexpr bool kRebuilt = false;
};

constexpr uint32_t kRowValueBias = 0x80000000u;
constexpr uint32_t kCompactPad = 0xffffu;

// Shared-memory index of slot i in an array of B-byte elements: the
// slot's bank bits (5 of them for 4 bytes, 4 for 8: a slot is two
// banks; a 2-byte key's word) XORed with the slot's bits above a
// round's group, under which no warp access of a round, a load or a
// store meets a bank conflict (an 8-byte access is served a half-warp
// at a time).  tests/test_torch_pair_sort.py checks every access.
// Linear over XOR: swz(a | b) = swz(a) ^ swz(b) for a, b with no bit in
// common.
template <int B, int W>
__device__ __forceinline__ int row_swz(int i) {
  if constexpr (B == 8)
    return i ^ ((i >> W) & 15);
  else if constexpr (B == 2)
    return i ^ (((i >> W) & 31) << 1);
  else
    return i ^ ((i >> W) & 31);
}

// The direction bits of a group's slots for stage k: bit u of the mask
// is bit k+1 of the position pos0 | u << e of slot u (pos0 has the
// group's bits [e, e+W) clear), as the reference's _directions() gives
// it.
__device__ __forceinline__ uint32_t row_directions(int pos0, int e, int k) {
  // bit k+1 is bit b of u: the slots with bit b of u set (b >= 1: the
  // substages of stage k are at most k); past the group (u < 2^W), none
  const int b = k + 1 - e;
  const uint32_t within = b == 1 ? 0xccccccccu : b == 2 ? 0xf0f0f0f0u
                          : b == 3 ? 0xff00ff00u : b == 4 ? 0xffff0000u : 0u;
  return (((pos0 >> (k + 1)) & 1) ? 0xffffffffu : 0u) ^ within;
}

// Whether a CTA round in the window [e, e+W) reads and writes only slots
// of the thread's own warp: a warp takes 32 consecutive groups, which
// for e <= 5 lie in its own aligned run of 32 << W slots (and a block of
// one warp holds the whole tile).  Between two such rounds the warp
// syncs alone, so its warps do not wait for each other.
__device__ __forceinline__ bool row_warp_local(int e) {
  return e <= 5 || blockDim.x == 32;
}

// The comparators' slots.  A policy moves a slot between shared memory
// (the CTA's own, or another CTA's of the cluster) and registers, and
// compare-exchanges two of them; desc flips the direction (the swap
// rule of network.cuh).
//
// ExactSlots: the keys as they are (T) and, with KV, the int32 values,
// in two swizzled arrays; W: log2 of a round's group.
template <typename T, bool KV, int W>
struct ExactSlots {
  static constexpr int kW = W;
  static constexpr bool kWord = false;
  struct Slot {
    T k;
    int v;
  };
  T* s;
  int* sv;
  __device__ __forceinline__ Slot get(int i) const {
    return Slot{s[row_swz<sizeof(T), W>(i)], KV ? sv[row_swz<4, W>(i)] : 0};
  }
  __device__ __forceinline__ void put(int i, const Slot& x) const {
    s[row_swz<sizeof(T), W>(i)] = x.k;
    if constexpr (KV) sv[row_swz<4, W>(i)] = x.v;
  }
  __device__ __forceinline__ ExactSlots at(cg::cluster_group& c,
                                           unsigned rank) const {
    return ExactSlots{c.map_shared_rank(s, rank),
                      KV ? c.map_shared_rank(sv, rank) : sv};
  }
  static __device__ __forceinline__ void exchange(Slot& a, Slot& b,
                                                  bool desc) {
    const bool swap = (KV ? gt_kv(a.k, a.v, b.k, b.v) : gt(a.k, b.k)) != desc;
    const Slot lo = swap ? b : a;
    b = swap ? a : b;
    a = lo;
  }
};

// WordSlots: one unsigned word a slot (U: 64 or 32 bits), the key
// integer (RowKey::to) in its bits from S up and below it a payload: a
// pair's value (packed: S = 32) or column (compact: S = 16), or for keys
// alone the key's own bits (S = 32 for float32, 16 for bf16) or nothing
// (S = 0).  HALF compares the key integers alone, so that two keys of one
// class (+-0.0 and the denormals) never trade places, as under the
// network's swap rule; else whole words are compared.
template <typename U, int W, int S, bool HALF = false>
struct WordSlots {
  static constexpr int kW = W;
  static constexpr bool kWord = true;
  static constexpr int kShift = S;
  using Slot = U;
  U* s;
  __device__ __forceinline__ Slot get(int i) const {
    return s[row_swz<sizeof(U), W>(i)];
  }
  __device__ __forceinline__ void put(int i, Slot x) const {
    s[row_swz<sizeof(U), W>(i)] = x;
  }
  __device__ __forceinline__ WordSlots at(cg::cluster_group& c,
                                          unsigned rank) const {
    return WordSlots{c.map_shared_rank(s, rank)};
  }
  // the key integer of a slot
  static __device__ __forceinline__ uint32_t key(Slot x) {
    return static_cast<uint32_t>(x >> S);
  }
  static __device__ __forceinline__ void exchange(Slot& a, Slot& b,
                                                  bool desc) {
    bool after;
    if constexpr (!HALF)
      after = a > b;
    else if constexpr (sizeof(U) == 8)
      after = key(a) > key(b);               // the high words
    else
      after = a > (b | ((U{1} << S) - 1));   // key(a) > key(b)
    const bool swap = after != desc;
    const Slot lo = swap ? b : a;
    b = swap ? a : b;
    a = lo;
  }
};

// Substages j_hi..j_lo of stage k on a group of 2^W slots held in
// registers, slot u at row position pos0 | u << e (e <= j_lo <= j_hi <
// e + W; the bounds are uniform over the block): pair (u, u | 2^(j-e))
// with bit j-e of u clear, in the direction of its lower slot.
template <typename P, int W>
__device__ __forceinline__ void row_substages(typename P::Slot (&x)[1 << W],
                                              int pos0, int e, int k,
                                              int j_lo, int j_hi) {
  const uint32_t dirs = row_directions(pos0, e, k);
#pragma unroll
  for (int b = W - 1; b >= 0; --b) {
    const int j = e + b;
    if (j < j_lo || j > j_hi) continue;
#pragma unroll
    for (int u = 0; u < (1 << W); ++u)
      if (!(u & (1 << b)))
        P::exchange(x[u], x[u | (1 << b)], (dirs >> u) & 1u);
  }
}

// The first round: stages 0..W-1 whole on the groups of 2^W consecutive
// slots of the CTA (W = P::kW, or log_l for a shorter row).
template <typename P, int W>
__device__ __forceinline__ void row_first_round(const P& tile, int log_l,
                                                int rank) {
  const int groups = (1 << log_l) >> W;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int base = g << W;
    typename P::Slot x[1 << W];
#pragma unroll
    for (int u = 0; u < (1 << W); ++u) x[u] = tile.get(base | u);
    const int pos0 = (rank << log_l) | base;
#pragma unroll
    for (int k = 0; k < W; ++k) row_substages<P, W>(x, pos0, 0, k, 0, k);
#pragma unroll
    for (int u = 0; u < (1 << W); ++u) tile.put(base | u, x[u]);
  }
}

// One round of stage k: substages j_hi..j_lo on groups of 2^W slots at
// positions base | u << e, base with bits [e, e+W) clear (E >= 0: e
// known at compile time, E; else e).  A CTA round takes the CTA's own
// groups (slots of its tile); a cluster round (REMOTE) takes groups
// rank * L/2^W + g of the whole row, each slot read from and written
// back to the CTA that holds it through distributed shared memory.  A
// group belongs to one thread, so a round reads and writes back the same
// slots with no other thread on them.
template <typename P, int E, bool REMOTE>
__device__ __forceinline__ void row_round(const P& tile, int log_l, int rank,
                                          int e_rt, int k, int j_lo,
                                          int j_hi) {
  constexpr int W = P::kW;
  const int e = E >= 0 ? E : e_rt;
  const int groups = (1 << log_l) >> W;
  const int mask = (1 << log_l) - 1;
  cg::cluster_group cluster = cg::this_cluster();
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int gg = REMOTE ? (rank << (log_l - W)) | g : g;
    const int base = ((gg >> e) << (e + W)) | (gg & ((1 << e) - 1));
    typename P::Slot x[1 << W];
#pragma unroll
    for (int u = 0; u < (1 << W); ++u) {
      const int p = base | (u << e);
      if constexpr (REMOTE)
        x[u] = tile.at(cluster, static_cast<unsigned>(p >> log_l))
                   .get(p & mask);
      else
        x[u] = tile.get(p);
    }
    row_substages<P, W>(x, REMOTE ? base : (rank << log_l) | base, e, k,
                        j_lo, j_hi);
#pragma unroll
    for (int u = 0; u < (1 << W); ++u) {
      const int p = base | (u << e);
      if constexpr (REMOTE)
        tile.at(cluster, static_cast<unsigned>(p >> log_l))
            .put(p & mask, x[u]);
      else
        tile.put(p, x[u]);
    }
  }
}

// A CTA round in its window; the windows of the main path's tiles
// (8,192 and 4,096 slots: 0, W and 8) with the window known at compile
// time, so that a slot's address is its group's and a constant.
template <typename P>
__device__ __forceinline__ void row_local_round(const P& tile, int log_l,
                                                int rank, int window, int k,
                                                int j_lo, int j_hi) {
  constexpr int W = P::kW;
  if (window == 0)
    row_round<P, 0, false>(tile, log_l, rank, 0, k, j_lo, j_hi);
  else if (window == W)
    row_round<P, W, false>(tile, log_l, rank, W, k, j_lo, j_hi);
  else if (window == 8)
    row_round<P, 8, false>(tile, log_l, rank, 8, k, j_lo, j_hi);
  else
    row_round<P, -1, false>(tile, log_l, rank, window, k, j_lo, j_hi);
}

// The whole network on a row's slots, held in the shared memory of the
// CTA (and of the cluster's other CTAs): the first round, then for each
// later stage a cluster round over its substages at distances of a
// slice or more (its top W) and rounds of the rest within the CTA,
// W-aligned from the bottom.  A round waits for the one before it with
// a barrier of the cluster (a cluster round), of the warp (two
// warp-local rounds) or of the block.
template <typename P>
__device__ __forceinline__ void row_network(const P& tile, const RowLaunch& r,
                                            int rank) {
  constexpr int W = P::kW;
  cg::cluster_group cluster = cg::this_cluster();
  const int w = r.log_l < W ? r.log_l : W;
  switch (w) {
    case 1: row_first_round<P, 1>(tile, r.log_l, rank); break;
    case 2: row_first_round<P, 2>(tile, r.log_l, rank); break;
    case 3: row_first_round<P, 3>(tile, r.log_l, rank); break;
    case 4: row_first_round<P, (W > 4 ? 4 : W)>(tile, r.log_l, rank); break;
    default: row_first_round<P, W>(tile, r.log_l, rank); break;
  }
  bool warp_pending = true;        // the last round's writes: its warp's
  for (int k = w; k < r.log_total; ++k) {
    int j_hi = k;
    if (k >= r.log_l) {            // the substages across CTAs
      cluster.sync();              // every CTA's slots are stored
      row_round<P, -1, true>(tile, r.log_l, rank, k - W + 1, k, k - W + 1, k);
      cluster.sync();              // and written back
      warp_pending = false;
      j_hi = k - W;
    }
    while (j_hi >= 0) {
      const int e = j_hi / W * W;
      const int window = e < r.log_l - W ? e : r.log_l - W;
      const bool local = row_warp_local(window);
      if (local && warp_pending)
        __syncwarp();
      else
        __syncthreads();
      row_local_round<P>(tile, r.log_l, rank, window, k, e, j_hi);
      warp_pending = local;
      j_hi = e - 1;
    }
  }
  __syncthreads();
}

// The reference's search (bucketize._bin_search_block, left side): the
// count of the first m sorted keys comparing below the query, in
// ceil(log2(m + 1)) guarded halvings; probe(i) is the comparison key of
// sorted slot i.  The same probes in the same order as the reference,
// so the same count for any row, NaN keys included.
template <typename K, typename Probe>
__device__ __forceinline__ int ref_search(Probe probe, int m, K key) {
  int steps = 0;
  while ((m >> steps) > 0) ++steps;
  int lo = 0, hi = m;
  for (int st = 0; st < steps; ++st) {
    const int mid = min((lo + hi) / 2, m - 1);
    const bool go_right = probe(mid) < key && lo < hi;
    lo = go_right ? mid + 1 : lo;
    hi = go_right ? hi : mid;
    hi = max(hi, lo);
  }
  return lo;
}

// A pair word's value: the biased value of a packed word, the column of
// a compact one.
template <typename U>
__device__ __forceinline__ int word_value(U x) {
  if constexpr (sizeof(U) == 8)
    return static_cast<int>(static_cast<uint32_t>(x) ^ kRowValueBias);
  else
    return static_cast<int>(x & kCompactPad);
}

// The sorted slice of a CTA to the real positions it holds, and with
// SEARCH the row's queries searched over the sorted row (each query by
// one thread of the cluster, each probe read from the CTA that holds
// the slot).  Word slots are unpacked: a pair's key of the zero class
// (+-0.0 and denormals, all one integer) is taken from the caller's row
// at its column, the slot's value; a key alone comes from its own bits
// below the key integer, or from the key integer (S = 0).
template <typename T, bool KV, bool SEARCH, typename P>
__device__ __forceinline__ void row_finish(const P& tile, const T* in,
                                           T* keys_out, int* order_out,
                                           const RowLaunch& r, int rank,
                                           long long row, const T* queries,
                                           int* cuts, long long nq) {
  constexpr bool kWord = P::kWord;
  const int L = 1 << r.log_l;
  const int log_c = r.log_total - r.log_l;
  cg::cluster_group cluster = cg::this_cluster();
  const long long col0 = static_cast<long long>(rank) << r.log_l;
  long long real = r.m - col0;
  real = real < 0 ? 0 : (real > L ? L : real);
  T* ko = keys_out + row * r.m + col0;
  int* vo = KV ? order_out + row * r.m + col0 : nullptr;
  for (int i = threadIdx.x; i < real; i += blockDim.x) {
    const auto x = tile.get(i);
    if constexpr (kWord && KV) {
      const uint32_t t = P::key(x);
      const int v = word_value(x);
      ko[i] = RowKey<T>::kRebuilt && t == RowKey<T>::kZero
                  ? in[v] : RowKey<T>::from(t);
      vo[i] = v;
    } else if constexpr (kWord) {
      ko[i] = P::kShift ? RowKey<T>::of_bits(static_cast<uint32_t>(x))
                        : RowKey<T>::from(P::key(x));
    } else {
      ko[i] = x.k;
      if constexpr (KV) vo[i] = x.v;
    }
  }
  if constexpr (SEARCH) {
    if (log_c) cluster.sync();     // every CTA's slice is sorted
    const int m = static_cast<int>(r.m);
    auto slot = [&](int i) {
      const unsigned owner = static_cast<unsigned>(i >> r.log_l);
      return (owner ? tile.at(cluster, owner) : tile).get(i & (L - 1));
    };
    for (long long qi = static_cast<long long>(rank) * blockDim.x +
                        threadIdx.x;
         qi < nq; qi += static_cast<long long>(blockDim.x) << log_c) {
      const T q = queries[row * nq + qi];
      int cut;
      if constexpr (kWord)         // a NaN query is below nothing: 0
        cut = RowKey<T>::nan(q) ? 0 : ref_search([&](int i) {
          return P::key(slot(i));
        }, m, RowKey<T>::to(q));
      else
        cut = ref_search([&](int i) { return cmp_key(slot(i).k); }, m,
                         cmp_key(q));
      cuts[row * nq + qi] = cut;
    }
    if (log_c) cluster.sync();     // no CTA leaves while others read it
  }
}

// The network and the write-out of a row in one representation.
template <typename T, bool KV, bool SEARCH, typename P>
__device__ __forceinline__ void row_run(const P& tile, const T* in,
                                        T* keys_out, int* order_out,
                                        const RowLaunch& r, int rank,
                                        long long row, const T* queries,
                                        int* cuts, long long nq) {
  row_network(tile, r, rank);
  row_finish<T, KV, SEARCH>(tile, in, keys_out, order_out, r, rank, row,
                            queries, cuts, nq);
}

// Where a row's CTA sits: its rank in the cluster (0 for a CTA a row),
// its row, and the row's first column it holds.
struct RowPlace {
  int rank;
  long long row, col0;
};
__device__ __forceinline__ RowPlace row_place(const RowLaunch& r) {
  const int log_c = r.log_total - r.log_l;
  const int rank =
      log_c ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  return RowPlace{rank, static_cast<long long>(blockIdx.x) >> log_c,
                  static_cast<long long>(rank) << r.log_l};
}

// The OR over the whole row of each thread's flags (bits kRowExact: a key
// that needs the exact comparator, kRowFolds: a key that folds to zero):
// over the CTA and, in a cluster, over its CTAs (cta_flags: the CTA's,
// read by the others).  Also the barrier after the load: every slot of
// every CTA is stored.
constexpr int kRowExact = 1, kRowFolds = 2;
__device__ __forceinline__ int row_flags(int flags, const RowLaunch& r,
                                         int& cta_flags) {
  flags = (__syncthreads_or(flags & kRowExact) ? kRowExact : 0) |
          (__syncthreads_or(flags & kRowFolds) ? kRowFolds : 0);
  const int log_c = r.log_total - r.log_l;
  if (log_c) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) cta_flags = flags;
    cluster.sync();
    flags = 0;
    for (int c = 0; c < (1 << log_c); ++c)
      flags |= *cluster.map_shared_rank(&cta_flags, c);
  }
  return flags;
}

// Sort one row of (key, int32 value) pairs a CTA (rows of up to
// 2^kRowLogSlice padded slots) or a cluster of CTAs (up to
// 2^kRowLogLaunch), blockIdx.x = row * CTAs + rank, the values given or
// generated (the column).  keys (and values) are (rows, m), read once;
// keys_out and order_out (rows, m), written once; with SEARCH the nq
// queries of each row (queries (rows, nq)) are searched into cuts (rows,
// nq).  The row loads as word slots (compact for bf16 keys with the
// values generated); if it needs the exact comparator (see RowKey), it
// loads again as key and value arrays.
template <typename T, bool SEARCH, int W>
__device__ __forceinline__ void row_pairs(
    const T* __restrict__ keys, const int* __restrict__ values,
    T* __restrict__ keys_out, int* __restrict__ order_out, const RowLaunch& r,
    const T* __restrict__ queries, int* cuts, long long nq,
    unsigned char* smem_raw, int& cta_flags) {
  using PackedSlots = WordSlots<u64, W, 32>;
  using CompactSlots = WordSlots<uint32_t, W, 16>;
  const int L = 1 << r.log_l;
  const RowPlace at = row_place(r);
  const T* in = keys + at.row * r.m;
  const int* vin = values ? values + at.row * r.m : nullptr;
  const bool compact = std::is_same<T, __nv_bfloat16>::value && !vin;

  // slot i of the CTA: the caller's key and value, or a pad (the sort
  // sentinel, int32 max); the value generated is the column
  auto load = [&](int i, T& key, int& val) {
    const long long col = at.col0 + i;
    const bool real = col < r.m;
    key = real ? in[col] : sentinel<T>();
    val = !real ? 0x7fffffff : (vin ? vin[col] : static_cast<int>(col));
  };
  const PackedSlots packed{reinterpret_cast<u64*>(smem_raw)};
  const CompactSlots small{reinterpret_cast<uint32_t*>(smem_raw)};
  int exact = 0;                   // a key here needs the exact comparator
  for (int i0 = threadIdx.x; i0 < L; i0 += kRowLoadBatch * blockDim.x) {
    T key[kRowLoadBatch];
    int val[kRowLoadBatch];
#pragma unroll
    for (int u = 0; u < kRowLoadBatch; ++u)
      if (i0 + u * blockDim.x < L) load(i0 + u * blockDim.x, key[u], val[u]);
#pragma unroll
    for (int u = 0; u < kRowLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < L) {
        // a folded key is rebuilt from its column: generated values only
        exact |= RowKey<T>::nan(key[u]) ||
                 (vin && RowKey<T>::folds(key[u]));
        const uint32_t t = RowKey<T>::to(key[u]);
        if (compact)
          small.put(i, (t << 16) | (val[u] == 0x7fffffff
                                        ? kCompactPad
                                        : static_cast<uint32_t>(val[u])));
        else
          packed.put(i, (static_cast<u64>(t) << 32) |
                            (static_cast<uint32_t>(val[u]) ^ kRowValueBias));
      }
    }
  }
  // the comparator of the whole row: exact if any CTA of it needs it
  if (!row_flags(exact ? kRowExact : 0, r, cta_flags)) {
    if (compact)
      row_run<T, true, SEARCH>(small, in, keys_out, order_out, r, at.rank,
                               at.row, queries, cuts, nq);
    else
      row_run<T, true, SEARCH>(packed, in, keys_out, order_out, r, at.rank,
                               at.row, queries, cuts, nq);
    return;
  }
  const ExactSlots<T, true, W> tile{
      reinterpret_cast<T*>(smem_raw),
      reinterpret_cast<int*>(smem_raw + L * sizeof(T))};
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    typename ExactSlots<T, true, W>::Slot x;
    load(i, x.k, x.v);
    tile.put(i, x);
  }
  __syncthreads();
  row_run<T, true, SEARCH>(tile, in, keys_out, order_out, r, at.rank, at.row,
                           queries, cuts, nq);
}

// Sort one row of keys alone, laid out as row_pairs lays pairs out (the
// same network: the keys-only swap rule, gt).  The row loads as 32-bit
// words: the key integer (float32, int32), or for bf16 the key integer
// over the key's bits, compared whole where no key folds, on the key
// half where some do.  A float32 row whose keys fold loads again as
// 64-bit words, the key integer over the key's bits, compared on the key
// half; a row with a NaN key loads again as the keys themselves.
template <typename T, bool SEARCH, int W>
__device__ __forceinline__ void row_keys(
    const T* __restrict__ keys, T* __restrict__ keys_out, const RowLaunch& r,
    const T* __restrict__ queries, int* cuts, long long nq,
    unsigned char* smem_raw, int& cta_flags) {
  constexpr bool kInt = std::is_same<T, int>::value;
  constexpr int kS = sizeof(T) == 2 ? 16 : 0;    // bf16: its bits below
  using Words = WordSlots<uint32_t, W, kS>;
  const int L = 1 << r.log_l;
  const RowPlace at = row_place(r);
  const T* in = keys + at.row * r.m;
  // slot i of the CTA: the caller's key, or a pad (the sort sentinel)
  auto load = [&](int i) {
    const long long col = at.col0 + i;
    return col < r.m ? in[col] : sentinel<T>();
  };
  const Words words{reinterpret_cast<uint32_t*>(smem_raw)};
  int flags = 0;
  for (int i0 = threadIdx.x; i0 < L; i0 += kRowLoadBatch * blockDim.x) {
    T key[kRowLoadBatch];
#pragma unroll
    for (int u = 0; u < kRowLoadBatch; ++u)
      if (i0 + u * blockDim.x < L) key[u] = load(i0 + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < kRowLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < L) {
        flags |= (RowKey<T>::nan(key[u]) ? kRowExact : 0) |
                 (RowKey<T>::folds(key[u]) ? kRowFolds : 0);
        const uint32_t t = RowKey<T>::to(key[u]);
        words.put(i, kS ? (t << kS) | RowKey<T>::bits(key[u]) : t);
      }
    }
  }
  flags = row_flags(flags, r, cta_flags);
  if (kInt || !flags) {            // int32 keys never hold a NaN or fold
    row_run<T, false, SEARCH>(words, in, keys_out, nullptr, r, at.rank,
                              at.row, queries, cuts, nq);
    return;
  }
  if constexpr (!kInt) {
    if (flags & kRowExact) {
      const ExactSlots<T, false, W> tile{reinterpret_cast<T*>(smem_raw),
                                         nullptr};
      for (int i = threadIdx.x; i < L; i += blockDim.x)
        tile.put(i, typename ExactSlots<T, false, W>::Slot{load(i), 0});
      __syncthreads();
      row_run<T, false, SEARCH>(tile, in, keys_out, nullptr, r, at.rank,
                                at.row, queries, cuts, nq);
    } else if constexpr (kS) {     // bf16: the same words, the key half
      const WordSlots<uint32_t, W, kS, true> half{words.s};
      row_run<T, false, SEARCH>(half, in, keys_out, nullptr, r, at.rank,
                                at.row, queries, cuts, nq);
    } else {                       // float32: 64-bit words, the key half
      const WordSlots<u64, W, 32, true> wide{reinterpret_cast<u64*>(smem_raw)};
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const T k = load(i);
        wide.put(i, (static_cast<u64>(RowKey<T>::to(k)) << 32) |
                        RowKey<T>::bits(k));
      }
      __syncthreads();
      row_run<T, false, SEARCH>(wide, in, keys_out, nullptr, r, at.rank,
                                at.row, queries, cuts, nq);
    }
  }
}

// One kernel a group size W (row_log_round), each with its own registers:
// with KV the pairs (row_pairs), else the keys alone (row_keys).
template <typename T, bool KV, bool SEARCH, int W>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
    row_sort(const T* __restrict__ keys, const int* __restrict__ values,
             T* __restrict__ keys_out, int* __restrict__ order_out,
             RowLaunch r, const T* __restrict__ queries, int* cuts,
             long long nq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int cta_flags;
  if constexpr (KV)
    row_pairs<T, SEARCH, W>(keys, values, keys_out, order_out, r, queries,
                            cuts, nq, smem_raw, cta_flags);
  else
    row_keys<T, SEARCH, W>(keys, keys_out, r, queries, cuts, nq, smem_raw,
                           cta_flags);
}

// One launch of row_sort<W> over rows of r.m keys padded to
// 2^r.log_total (<= kRowLogLaunch): a CTA a row, or clusters of
// 2^(log_total - kRowLogSlice) CTAs.
template <typename T, bool KV, bool SEARCH, int W>
int launch_row_sort_w(const T* keys, const int* values, T* keys_out,
                      int* order_out, long long rows, const RowLaunch& r,
                      const T* queries, int* cuts, long long nq,
                      cudaStream_t stream) {
  // once per instantiation: room for the largest slice
  static const cudaError_t configured = cudaFuncSetAttribute(
      row_sort<T, KV, SEARCH, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(row_smem(kRowLogSlice)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int log_c = r.log_total - r.log_l;
  const int threads = (1 << r.log_l) >> W;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows << log_c));
  cfg.blockDim = dim3(threads < 32 ? 32 : threads);
  cfg.dynamicSmemBytes = row_smem(r.log_l);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = log_c ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, row_sort<T, KV, SEARCH, W>, keys, values, keys_out, order_out, r,
      queries, cuts, nq);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The kernel of the rows' group size (row_log_round) and its launch.
template <typename T, bool KV, bool SEARCH>
int launch_row_sort(const T* keys, const int* values, T* keys_out,
                    int* order_out, long long rows, long long m,
                    int log_total, const T* queries, int* cuts, long long nq,
                    cudaStream_t stream) {
  const RowLaunch r{m, log_total,
                    log_total < kRowLogSlice ? log_total : kRowLogSlice};
  if (row_log_round(r.log_l) == kRowLogRound)
    return launch_row_sort_w<T, KV, SEARCH, kRowLogRound>(
        keys, values, keys_out, order_out, rows, r, queries, cuts, nq,
        stream);
  return launch_row_sort_w<T, KV, SEARCH, 4>(keys, values, keys_out,
                                             order_out, rows, r, queries,
                                             cuts, nq, stream);
}

// The reference's left search of each row's nq queries over the first
// m of its n sorted keys, one thread a query: the split schedule's
// search for rows past kRowLogLaunch.
template <typename T>
__global__ void search_rows(const T* sk, long long n, long long m,
                            const T* queries, int* cuts, long long total,
                            long long nq) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= total) return;
  const T* x = sk + (idx / nq) * n;
  cuts[idx] = ref_search([&](int i) { return cmp_key(x[i]); },
                         static_cast<int>(m), cmp_key(queries[idx]));
}

// Rows of m keys (and with sv, values or the column generated) padded to
// n slots in scratch: the tile_stages schedule's operand for rows past
// kRowLogLaunch.
template <typename T>
__global__ void pad_rows(const T* keys, const int* values, T* sk, int* sv,
                         long long total, long long m, long long n) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / n, col = idx % n;
  const bool real = col < m;
  sk[idx] = real ? keys[row * m + col] : sentinel<T>();
  if (sv)
    sv[idx] = !real ? 0x7fffffff
                    : (values ? values[row * m + col] : static_cast<int>(col));
}

// The sort of (rows, m) keys into keys_out, with KV of (key, value)
// pairs (values null: the column, the stable argsort) with the order
// into order_out, and with SEARCH the left search of each row's nq
// queries into cuts.  Up to kRowLogLaunch padded slots a row: one
// row_sort launch.  Past it (direct calls only: the dispatch sends such
// rows to the radix sort) the rows are padded into the scratch (sk, and
// with KV sv: (rows, 2^log_total)), sorted there by the tile_stages
// schedule, searched by search_rows and copied out.
template <typename T, bool KV, bool SEARCH>
int sort_unpadded(const T* keys, const int* values, T* keys_out,
                  int* order_out, T* sk, int* sv, long long rows, long long m,
                  const T* queries, int* cuts, long long nq,
                  cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (m >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int log_total = log2_exact(m < 2 ? 2 : m);
  if (log_total <= kRowLogLaunch)
    return launch_row_sort<T, KV, SEARCH>(keys, values, keys_out, order_out,
                                          rows, m, log_total, queries, cuts,
                                          nq, stream);
  if (sk == nullptr || (KV && sv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 1LL << log_total;
  const long long total = rows * n;
  pad_rows<T><<<(total + 255) / 256, 256, 0, stream>>>(
      keys, values, sk, KV ? sv : nullptr, total, m, n);
  const int err = sort_rows<T, KV>(sk, sv, rows, n, stream);
  if (err != 0) return err;
  if (SEARCH && nq > 0)
    search_rows<T><<<(rows * nq + 255) / 256, 256, 0, stream>>>(
        sk, n, m, queries, cuts, rows * nq, nq);
  cudaError_t c = cudaMemcpy2DAsync(keys_out, m * sizeof(T), sk,
                                    n * sizeof(T), m * sizeof(T), rows,
                                    cudaMemcpyDeviceToDevice, stream);
  if (KV && c == cudaSuccess)
    c = cudaMemcpy2DAsync(order_out, m * sizeof(int), sv, n * sizeof(int),
                          m * sizeof(int), rows, cudaMemcpyDeviceToDevice,
                          stream);
  return static_cast<int>(c != cudaSuccess ? c : cudaGetLastError());
}

}  // namespace
}  // namespace repro
