// Row-wise ascending bitonic sort of a (rows, n) array, n a power of two,
// of keys alone (bitonic_sort_*) or of (key, int32 value) pairs in
// lexicographic order (bitonic_sort_kv_*).
//
// Replaces: src/repro/kernels/bitonic.py bitonic_sort (pallas_call at
// :224; body _sort_kernel :169 -> sort_network_block :112) and
// bitonic_sort_kv (pallas_call at :254; body _sort_kv_kernel :173 ->
// sort_network_block_kv -> _compare_exchange_kv :89).  Same network,
// same pairs, same directions, same swap rule, so the result is bitwise
// the one of the plain versions in repro_torch/kernels/bitonic.py, ties
// between equal-comparing values (-0.0, +0.0, denormals) included.  Fed
// values = arange(n), the pair sort is the stable argsort: every pair
// is distinct, so the order is the lexicographic one whatever the
// network.
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
//
// The pair sort runs the same split with a second channel: a tile of
// 8192 pairs needs 64 KiB of shared memory, above the 48 KiB a launch
// gets by default, so the kv entry points raise the kernel's dynamic
// shared-memory limit first (cudaFuncSetAttribute).  It moves twice the
// bytes of the keys-only sort on every pass.
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kLogTile = 13;          // 8192 elements per shared-memory tile
constexpr int kThreads = 1024;

// Stages k in [k_lo, k_hi], each with its substages j from
// min(k, log_tile - 1) down to 0, on each tile of 2^log_tile
// consecutive elements.  A tile never straddles two rows (it divides
// n); the direction comes from the element's position in its row.
// With KV the values v move with the keys (their tile follows the
// keys' tile in shared memory).
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

template <typename T, bool KV>
int sort_rows(T* x, int* v, long long rows, long long n,
              cudaStream_t stream) {
  if (rows <= 0 || n < 2) return static_cast<int>(cudaGetLastError());
  const int log_n = log2_exact(n);
  const int log_tile = log_n < kLogTile ? log_n : kLogTile;
  const int tile = 1 << log_tile;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const long long blocks = rows * n / tile;
  const size_t smem = tile * (sizeof(T) + (KV ? sizeof(int) : 0));
  if (KV) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_stages<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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

}  // namespace

extern "C" int bitonic_sort_f32(float* x, long long rows, long long n,
                                void* stream) {
  return sort_rows<float, false>(x, nullptr, rows, n,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_sort_i32(int* x, long long rows, long long n,
                                void* stream) {
  return sort_rows<int, false>(x, nullptr, rows, n,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_sort_kv_f32(float* k, int* v, long long rows,
                                   long long n, void* stream) {
  return sort_rows<float, true>(k, v, rows, n,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_sort_kv_i32(int* k, int* v, long long rows,
                                   long long n, void* stream) {
  return sort_rows<int, true>(k, v, rows, n,
                              static_cast<cudaStream_t>(stream));
}
