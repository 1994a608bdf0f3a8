// Row-wise ascending bitonic sort of a (rows, n) array, n a power of two.
//
// Replaces: src/repro/kernels/bitonic.py bitonic_sort (pallas_call at
// :224; body _sort_kernel :169 -> sort_network_block :112).  Same
// network, same pairs, same directions, same swap rule, so the result
// is bitwise the one of the plain version in
// repro_torch/kernels/bitonic.py, ties between equal-comparing values
// (-0.0, +0.0, denormals) included.
//
// What bounds it on the H100.  The TPU kernel keeps a whole row (up to
// 2^16 lanes, 256 KiB of f32) in VMEM.  A Hopper block has at most
// 227 KB of shared memory and the main path's rows are exactly 2^16
// f32, so a row cannot stay on chip.  The network's log2(n)(log2(n)+1)/2
// substages are split the usual GPU way:
//   * every substage at a distance below kTile runs in shared memory on
//     tiles of kTile elements (32 KiB of f32): one launch for all stages
//     up to log2(kTile), then one launch per larger stage for its
//     in-tile tail;
//   * each substage at a distance of kTile or more is one pass over
//     global memory, one thread per pair.
// At (64, 65536) f32 that is 10 launches and about 10 round trips of
// the 16 MiB array, so it is bound by device-memory bytes of those
// passes plus shared-memory traffic, not by the 2 x 16 MiB the sort
// must move.  A row is spread over n / kTile blocks (8 at the main
// path's width, 512 blocks in all), so 64 rows do not leave most of
// the 132 SMs idle.
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kLogTile = 13;          // 8192 elements per shared-memory tile
constexpr int kThreads = 1024;

// Stages k in [k_lo, k_hi], each with its substages j from
// min(k, log_tile - 1) down to 0, on each tile of 2^log_tile
// consecutive elements.  A tile never straddles two rows (it divides
// n); the direction comes from the element's position in its row.
template <typename T>
__global__ void tile_stages(T* x, long long n, int log_tile, int k_lo,
                            int k_hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log_tile;
  const long long base = (long long)blockIdx.x * tile;
  const long long col0 = base % n;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  const int half = tile / 2;
  for (int k = k_lo; k <= k_hi; ++k) {
    for (int j = min(k, log_tile - 1); j >= 0; --j) {
      const int d = 1 << j;
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int p = ((q >> j) << (j + 1)) | (q & (d - 1));
        const bool desc = (((col0 + p) >> (k + 1)) & 1) != 0;
        compare_exchange(s, p, d, desc);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) x[base + i] = s[i];
}

template <typename T>
int sort_rows(T* x, long long rows, long long n, cudaStream_t stream) {
  if (rows <= 0 || n < 2) return static_cast<int>(cudaGetLastError());
  const int log_n = log2_exact(n);
  const int log_tile = log_n < kLogTile ? log_n : kLogTile;
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const long long blocks = rows * n / tile;
  const size_t smem = tile * sizeof(T);
  tile_stages<T><<<blocks, threads, smem, stream>>>(x, n, log_tile, 0,
                                                    log_tile - 1);
  const long long pairs = rows * n / 2;
  const int gthreads = 256;
  const long long gblocks = (pairs + gthreads - 1) / gthreads;
  for (int k = log_tile; k < log_n; ++k) {
    for (int j = k; j >= log_tile; --j)
      global_substage<T><<<gblocks, gthreads, 0, stream>>>(
          x, pairs, n, 1LL << j, k, true);
    tile_stages<T><<<blocks, threads, smem, stream>>>(x, n, log_tile, k, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bitonic_sort_f32(float* x, long long rows, long long n,
                                void* stream) {
  return sort_rows(x, rows, n, static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_sort_i32(int* x, long long rows, long long n,
                                void* stream) {
  return sort_rows(x, rows, n, static_cast<cudaStream_t>(stream));
}
