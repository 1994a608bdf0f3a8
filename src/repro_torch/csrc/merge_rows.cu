// Merge of sorted runs: each (total,)-row of a (batch, total) array holds
// total / run sorted runs of length run; all are powers of two.  The
// result is each row sorted.
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
// launch latency, not by arithmetic.
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kLogTile = 13;          // 8192 elements per shared-memory tile
constexpr int kThreads = 1024;
constexpr int kPairsPerThread = (1 << kLogTile) / 2 / kThreads;

template <typename T>
__device__ void cascade(T* s, int half, int top) {
  for (int d = top; d >= 1; d >>= 1) {
    for (int q = threadIdx.x; q < half; q += blockDim.x)
      compare_exchange(s, pair_low(q, d), d, false);
    __syncthreads();
  }
}

// On each tile: either the levels lvl = run .. tile/2 (flip, then the
// cascade lvl/2 .. 1), or with cascade_only the cascade tile/2 .. 1 that
// finishes a level merged by global passes.
template <typename T>
__global__ void tile_merge(T* x, int log_tile, long long run,
                           bool cascade_only) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log_tile;
  const int half = tile / 2;
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  if (cascade_only) {
    cascade(s, half, half);
  } else {
    for (int lvl = (int)run; 2 * lvl <= tile; lvl *= 2) {
      T lo[kPairsPerThread], hi[kPairsPerThread];
      int r = 0;
      for (int q = threadIdx.x; q < half; q += blockDim.x, ++r) {
        const int b0 = (q / lvl) * 2 * lvl, i = q % lvl;
        const T a = s[b0 + i], b = s[b0 + 2 * lvl - 1 - i];
        const bool swap = gt(a, b);
        lo[r] = swap ? b : a;
        hi[r] = swap ? a : b;
      }
      __syncthreads();
      r = 0;
      for (int q = threadIdx.x; q < half; q += blockDim.x, ++r) {
        const int b0 = (q / lvl) * 2 * lvl, i = q % lvl;
        s[b0 + i] = lo[r];
        s[b0 + lvl + i] = hi[r];
      }
      __syncthreads();
      cascade(s, half, lvl / 2);
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) x[base + i] = s[i];
}

// The flip of one level with lvl >= tile, in place over global memory.
// Thread (block, i), i < lvl/2, owns pairs i and lvl-1-i: together they
// read and write the same four slots, so no other thread touches them.
template <typename T>
__global__ void global_flip(T* x, long long n_threads, long long lvl) {
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= n_threads) return;
  const long long per_block = lvl / 2;
  T* y = x + (q / per_block) * 2 * lvl;
  const long long i = q % per_block, i2 = lvl - 1 - i;
  const T a1 = y[i], b1 = y[2 * lvl - 1 - i];
  const T a2 = y[i2], b2 = y[lvl + i];
  const bool s1 = gt(a1, b1), s2 = gt(a2, b2);
  y[i] = s1 ? b1 : a1;
  y[lvl + i] = s1 ? a1 : b1;
  y[i2] = s2 ? b2 : a2;
  y[lvl + i2] = s2 ? a2 : b2;
}

template <typename T>
int merge_runs(T* x, long long batch, long long total, long long run,
               cudaStream_t stream) {
  if (batch <= 0 || total <= run) return static_cast<int>(cudaGetLastError());
  const int log_total = log2_exact(total);
  const int log_tile = log_total < kLogTile ? log_total : kLogTile;
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const long long blocks = batch * total / tile;
  const size_t smem = tile * sizeof(T);
  if (2 * run <= tile)
    tile_merge<T><<<blocks, threads, smem, stream>>>(x, log_tile, run, false);
  const int gthreads = 256;
  const long long pairs = batch * total / 2;
  const long long flips = batch * total / 4;
  for (long long lvl = run > tile ? run : tile; lvl < total; lvl *= 2) {
    global_flip<T><<<(flips + gthreads - 1) / gthreads, gthreads, 0,
                     stream>>>(x, flips, lvl);
    for (long long d = lvl / 2; d >= tile; d /= 2)
      global_substage<T><<<(pairs + gthreads - 1) / gthreads, gthreads, 0,
                           stream>>>(x, pairs, total, d, 0, false);
    tile_merge<T><<<blocks, threads, smem, stream>>>(x, log_tile, 0, true);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int merge_rows_f32(float* x, long long batch, long long total,
                              long long run, void* stream) {
  return merge_runs(x, batch, total, run, static_cast<cudaStream_t>(stream));
}

extern "C" int merge_rows_i32(int* x, long long batch, long long total,
                              long long run, void* stream) {
  return merge_runs(x, batch, total, run, static_cast<cudaStream_t>(stream));
}
