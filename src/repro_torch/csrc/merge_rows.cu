// Merge of sorted runs: each (total,)-row of a (batch, total) array holds
// total / run sorted runs of length run; all are powers of two.  The
// result is each row sorted: keys alone (merge_rows_*), or (key, int32
// id) pairs in lexicographic order (merge_rows_kv_*).
//
// Replaces: src/repro/kernels/bitonic.py merge_sorted_rows (:335) via
// _merge_levels (:297, pallas_call at :313, body _merge_kernel ->
// merge_network_block :146), the keys-only receive merge of the Round-3
// shuffle while the padded receive buffer fits one tile.  The network
// is the reference's: level lvl = run, 2 run, ... merges adjacent runs
// by reversing the second one and running the ascending half-cleaner
// cascade at distances lvl, lvl/2, ..., 1 (:155-165).  The reference
// groups levels into row-group blocks; the grouping does not change the
// sequence of compare-exchanges any element sees, so this kernel is
// bitwise equal to the plain version in repro_torch/kernels/bitonic.py.
//
// The kv entry points replace the argsort variant of the same merge
// (_merge_levels with ip, pallas_call at :321, body _merge_kv_kernel
// :183; wrapper merge_sorted_rows_argsort :351), the receive merge that
// carries the stable order when SMMS moves values.  The ids are the
// unique flat positions of _pad_iota_unique, so every (key, id) pair is
// distinct and the merged order is exact.
//
// What bounds it on the H100.  The TPU merges a block of rows in VMEM.
// Here the levels whose runs fit a kTile tile (32 KiB of f32) run in
// shared memory in one launch; each larger level is one global pass for
// the flip, one global pass per cascade distance of kTile or more, and
// one shared-memory launch for the rest of the cascade.  The reversal
// is never materialized: the flip reads pair i as (a[i], b[lvl-1-i]) and
// writes lo to i and hi to lvl + i, which is where the reference's
// reversed layout puts them.  At the small configuration (8 machines,
// 8 x 2048 padded slots each) every level but the last fits a tile, so
// the kernel is bound by a few passes over the 512 KiB buffer and by
// launch latency, not by arithmetic.  The kv variant moves a second
// 4-byte channel through the same passes; its tile of 8192 pairs takes
// 64 KiB of dynamic shared memory, allowed by cudaFuncSetAttribute.
// Keys are float32, int32 or bf16 (moved as bf16, compared as float32:
// network.cuh cmp_key).
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kLogTile = 13;          // 8192 elements per shared-memory tile
constexpr int kThreads = 1024;
constexpr int kPairsPerThread = (1 << kLogTile) / 2 / kThreads;

template <typename T, bool KV>
__device__ void cascade(T* s, int* sv, int half, int top) {
  for (int d = top; d >= 1; d >>= 1) {
    for (int q = threadIdx.x; q < half; q += blockDim.x)
      compare_exchange_any<T, KV>(s, sv, pair_low(q, d), d, false);
    __syncthreads();
  }
}

// On each tile: either the levels lvl = run .. tile/2 (flip, then the
// cascade lvl/2 .. 1), or with cascade_only the cascade tile/2 .. 1 that
// finishes a level merged by global passes.  With KV the ids v move with
// the keys (their tile follows the keys' tile in shared memory).
template <typename T, bool KV>
__global__ void tile_merge(T* x, int* v, int log_tile, long long run,
                           bool cascade_only) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log_tile;
  const int half = tile / 2;
  int* sv = reinterpret_cast<int*>(s + tile);
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    s[i] = x[base + i];
    if constexpr (KV) sv[i] = v[base + i];
  }
  __syncthreads();
  if (cascade_only) {
    cascade<T, KV>(s, sv, half, half);
  } else {
    for (int lvl = (int)run; 2 * lvl <= tile; lvl *= 2) {
      T lo[kPairsPerThread], hi[kPairsPerThread];
      int vlo[kPairsPerThread], vhi[kPairsPerThread];
      int r = 0;
      for (int q = threadIdx.x; q < half; q += blockDim.x, ++r) {
        const int b0 = (q / lvl) * 2 * lvl, i = q % lvl;
        const int ia = b0 + i, ib = b0 + 2 * lvl - 1 - i;
        const T a = s[ia], b = s[ib];
        if constexpr (KV) {
          const int va = sv[ia], vb = sv[ib];
          const bool swap = gt_kv(a, va, b, vb);
          vlo[r] = swap ? vb : va;
          vhi[r] = swap ? va : vb;
          lo[r] = swap ? b : a;
          hi[r] = swap ? a : b;
        } else {
          const bool swap = gt(a, b);
          lo[r] = swap ? b : a;
          hi[r] = swap ? a : b;
        }
      }
      __syncthreads();
      r = 0;
      for (int q = threadIdx.x; q < half; q += blockDim.x, ++r) {
        const int b0 = (q / lvl) * 2 * lvl, i = q % lvl;
        s[b0 + i] = lo[r];
        s[b0 + lvl + i] = hi[r];
        if constexpr (KV) {
          sv[b0 + i] = vlo[r];
          sv[b0 + lvl + i] = vhi[r];
        }
      }
      __syncthreads();
      cascade<T, KV>(s, sv, half, lvl / 2);
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    x[base + i] = s[i];
    if constexpr (KV) v[base + i] = sv[i];
  }
}

// The flip of one level with lvl >= tile, in place over global memory.
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

template <typename T, bool KV>
int merge_runs(T* x, int* v, long long batch, long long total, long long run,
               cudaStream_t stream) {
  if (batch <= 0 || total <= run) return static_cast<int>(cudaGetLastError());
  const int log_total = log2_exact(total);
  const int log_tile = log_total < kLogTile ? log_total : kLogTile;
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const long long blocks = batch * total / tile;
  const size_t smem = tile * (sizeof(T) + (KV ? sizeof(int) : 0));
  if (KV) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_merge<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (2 * run <= tile)
    tile_merge<T, KV><<<blocks, threads, smem, stream>>>(x, v, log_tile, run,
                                                         false);
  const int gthreads = 256;
  const long long pairs = batch * total / 2;
  const long long flips = batch * total / 4;
  for (long long lvl = run > tile ? run : tile; lvl < total; lvl *= 2) {
    global_flip<T, KV><<<(flips + gthreads - 1) / gthreads, gthreads, 0,
                         stream>>>(x, v, flips, lvl);
    for (long long d = lvl / 2; d >= tile; d /= 2)
      global_substage<T, KV><<<(pairs + gthreads - 1) / gthreads, gthreads, 0,
                               stream>>>(x, v, pairs, total, d, 0, false);
    tile_merge<T, KV><<<blocks, threads, smem, stream>>>(x, v, log_tile, 0,
                                                         true);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int merge_rows_f32(float* x, long long batch, long long total,
                              long long run, void* stream) {
  return merge_runs<float, false>(x, nullptr, batch, total, run,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int merge_rows_i32(int* x, long long batch, long long total,
                              long long run, void* stream) {
  return merge_runs<int, false>(x, nullptr, batch, total, run,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int merge_rows_kv_f32(float* k, int* v, long long batch,
                                 long long total, long long run,
                                 void* stream) {
  return merge_runs<float, true>(k, v, batch, total, run,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int merge_rows_kv_i32(int* k, int* v, long long batch,
                                 long long total, long long run,
                                 void* stream) {
  return merge_runs<int, true>(k, v, batch, total, run,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int merge_rows_bf16(__nv_bfloat16* x, long long batch,
                               long long total, long long run, void* stream) {
  return merge_runs<__nv_bfloat16, false>(x, nullptr, batch, total, run,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int merge_rows_kv_bf16(__nv_bfloat16* k, int* v, long long batch,
                                  long long total, long long run,
                                  void* stream) {
  return merge_runs<__nv_bfloat16, true>(k, v, batch, total, run,
                                         static_cast<cudaStream_t>(stream));
}
