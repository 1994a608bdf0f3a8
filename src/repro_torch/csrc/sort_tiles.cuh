// The row-wise bitonic sort network split between shared and global
// memory, shared by csrc/bitonic_sort.cu (the sort) and
// csrc/sort_partition.cu (the sort fused with the boundary search).
//
// Rows of n elements (a power of two) lie back to back.  The network's
// log2(n)(log2(n)+1)/2 substages are split the usual GPU way:
//   * every substage at a distance below the tile runs in shared memory
//     on tiles of 2^kLogTile elements: one launch for all stages up to
//     log2(tile), then one launch per larger stage for its in-tile tail;
//   * each substage at a distance of a tile or more is one pass over
//     global memory, one thread per pair (global_substage, network.cuh).
// With KV an int32 value channel moves with the keys; its tile follows
// the keys' tile in shared memory (64 KiB at 8192 pairs, past the 48 KiB
// a launch gets by default, so the limit is raised first).
//
// The fused search (SEARCH).  After the last stage's in-tile tail, each
// tile of a row holds a contiguous, sorted slice of the sorted row.  So
// that launch can also count, while the tile is still in shared memory,
// how many of its elements with a row index below m compare below each
// of the row's queries (the reference's left rule, folded by cmp_key),
// and add the count to the row's cut with atomicAdd.  A sum of integer
// counts does not depend on the order the blocks run in, so the cuts are
// exact whatever the schedule.  The cuts are cleared on the same stream
// first.
#pragma once

#include "network.cuh"

namespace repro {

constexpr int kLogTile = 13;          // 8192 elements per shared-memory tile
constexpr int kThreads = 1024;

// What the fused search reads and writes: queries and cuts are
// (rows, nq) row-major, m the count of real elements in each row.
template <typename T>
struct TileSearch {
  const T* queries;
  int* cuts;
  long long m;
  long long nq;
};

// Stages k in [k_lo, k_hi], each with its substages j from
// min(k, log_tile - 1) down to 0, on each tile of 2^log_tile
// consecutive elements.  A tile never straddles two rows (it divides
// n); the direction comes from the element's position in its row.
template <typename T, bool KV, bool SEARCH>
__global__ void tile_stages(T* x, int* v, long long n, int log_tile,
                            int k_lo, int k_hi, TileSearch<T> search) {
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
  if constexpr (SEARCH) {
    // one thread per query: a lower bound over the tile's real elements
    const long long row = base / n;
    long long real = search.m - col0;
    real = real < 0 ? 0 : (real > tile ? tile : real);
    for (long long qi = threadIdx.x; real > 0 && qi < search.nq;
         qi += blockDim.x) {
      const cmp_t<T> key =
          cmp_key(search.queries[row * search.nq + qi]);
      int lo = 0, hi = static_cast<int>(real);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cmp_key(s[mid]) < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo > 0) atomicAdd(search.cuts + row * search.nq + qi, lo);
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    x[base + i] = s[i];
    if constexpr (KV) v[base + i] = sv[i];
  }
}

template <typename T, bool KV, bool SEARCH>
cudaError_t launch_tiles(T* x, int* v, long long n, int log_tile, int k_lo,
                         int k_hi, const TileSearch<T>& search,
                         long long blocks, int threads, size_t smem,
                         cudaStream_t stream) {
  if (KV) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_stages<T, KV, SEARCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tile_stages<T, KV, SEARCH><<<blocks, threads, smem, stream>>>(
      x, v, n, log_tile, k_lo, k_hi, search);
  return cudaSuccess;
}

// Sort each row of x (and v with KV) in place.  With fuse_search the
// last in-tile launch also searches the rows' queries into search.cuts.
template <typename T, bool KV>
int sort_rows(T* x, int* v, long long rows, long long n,
              const TileSearch<T>& search, bool fuse_search,
              cudaStream_t stream) {
  if (fuse_search && rows > 0 && search.nq > 0) {
    const cudaError_t err = cudaMemsetAsync(
        search.cuts, 0, sizeof(int) * rows * search.nq, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows <= 0 || n < 2) return static_cast<int>(cudaGetLastError());
  const int log_n = log2_exact(n);
  const int log_tile = log_n < kLogTile ? log_n : kLogTile;
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const long long blocks = rows * n / tile;
  const size_t smem = tile * (sizeof(T) + (KV ? sizeof(int) : 0));
  auto tiles = [&](int k_lo, int k_hi) {
    if (fuse_search && k_hi == log_n - 1)
      return launch_tiles<T, KV, true>(x, v, n, log_tile, k_lo, k_hi, search,
                                       blocks, threads, smem, stream);
    return launch_tiles<T, KV, false>(x, v, n, log_tile, k_lo, k_hi, search,
                                      blocks, threads, smem, stream);
  };
  cudaError_t err = tiles(0, log_tile - 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = rows * n / 2;
  const int gthreads = 256;
  const long long gblocks = (pairs + gthreads - 1) / gthreads;
  for (int k = log_tile; k < log_n; ++k) {
    for (int j = k; j >= log_tile; --j)
      global_substage<T, KV><<<gblocks, gthreads, 0, stream>>>(
          x, v, pairs, n, 1LL << j, k, true);
    err = tiles(k, k);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
