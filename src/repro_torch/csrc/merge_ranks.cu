// Global rank of every (key, id) pair of t sorted rows, per batch entry.
//
// keys, ids: (batch, t, w) with row stride w; the first c slots of each
// row are real and lexicographically increasing in (key, id).  pos:
// (batch, t, w) int32, pos[b, i, j] = the number of real pairs of rows
// 0..t-1 of batch entry b that are lexicographically < (key, id)[b, i, j]
// -- the element's index in the merged order.  The caller keeps the
// first c slots of each row.
//
// Replaces: src/repro/kernels/fused.py merge_ranks (:237; pallas_call
// at :272 with body _rank_kernel :163 -> _bin_search_pairs_block :139,
// and at :286 with body _rank_kernel_blocked :209 ->
// _bin_search_pairs_bounded :182) -- the Round-3 receive merge once the
// padded receive buffer exceeds one tile.
//
// Translation.  On the TPU the bound rows are a sequential grid axis
// and the rank accumulates in the resident output block.  Hopper blocks
// run in no order, so that axis becomes a loop inside the thread: each
// thread owns one query and sums its per-row counts in a register.
// With bound_block > 0 each bound row is counted block by block, as the
// reference's blocked variant splits its columns (:209).  Every count
// is exact, so the ranks are bitwise the reference's whichever way a
// row is searched.
//
// What bounds it on the H100.  At the main path's shape (64 machines x
// 64 rows x 4096 slots) there are 16.7M queries and 64 bound rows each.
// A first version searched every bound row whole for every query: 64
// rows x 2 blocks x 12 dependent probes per thread, 33 ms, bound by
// the issue of those probe instructions.  This version uses the rows'
// order: a block owns kQueryTile consecutive queries of one row, which
// are increasing, so their count in bound row k lies between the
// counts of the tile's first and last query.  Those 2t counts are
// searched once per block (by 2t threads at once) into shared memory;
// each thread then searches only that window, ~log2(kQueryTile) probes
// per row on near-uniform data, and a column block that lies wholly
// below or above the window costs no probe at all.
//
// Any t and any row width: the windows are searched kRowChunk bound
// rows at a time (one pass for t <= 512, as on the main path), and
// positions stay int32 while a batch entry holds fewer than 2^31
// slots.  Keys are float32, int32 or bf16 (compared as float32,
// network.cuh cmp_key).
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kQueryTile = 256;     // queries per block, one per thread
constexpr int kRowChunk = 512;      // bound rows whose windows a pass holds

// (km, im) < (qk, qi) lexicographically; keys already cmp_key-folded.
template <typename K>
__device__ __forceinline__ bool pair_less(K km, int im, K qk, int qi) {
  return (km < qk) || (km == qk && im < qi);
}

// lo + the number of pairs of rk/ri[lo, hi) below (qk, qi): a binary
// search of the sorted slice, ceil(log2(hi - lo + 1)) halvings.
template <typename T>
__device__ int count_below(const T* rk, const int* ri, int lo, int hi,
                           cmp_t<T> qk, int qi) {
  while (lo < hi) {
    // lo + hi < 2^32: the unsigned sum cannot wrap, and its shift is
    // the floor the reference's (lo + hi) // 2 takes
    const int mid = static_cast<int>((static_cast<unsigned>(lo) + hi) >> 1);
    if (pair_less(cmp_key(rk[mid]), ri[mid], qk, qi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void ranks(const T* keys, const int* ids, int* pos, int t,
                      long long w, int c, int bound_block) {
  __shared__ int first_count[kRowChunk];
  __shared__ int last_count[kRowChunk];
  const long long tiles = (w + kQueryTile - 1) / kQueryTile;
  const long long tile = blockIdx.x % tiles;
  const long long row = (blockIdx.x / tiles) % t;
  const long long entry = blockIdx.x / (tiles * t);
  const T* K = keys + entry * t * w;
  const int* I = ids + entry * t * w;
  const long long j0 = tile * kQueryTile;
  const long long j1 = (j0 + kQueryTile < w ? j0 + kQueryTile : w) - 1;
  const long long j = j0 + threadIdx.x;
  const bool mine = j <= j1;
  const cmp_t<T> qk = cmp_key(K[row * w + (mine ? j : j1)]);
  const int qi = I[row * w + (mine ? j : j1)];
  const cmp_t<T> fk = cmp_key(K[row * w + j0]);
  const cmp_t<T> lk = cmp_key(K[row * w + j1]);
  const int fi = I[row * w + j0], li = I[row * w + j1];
  const int bb = bound_block > 0 ? bound_block : c;
  int rank = 0;
  // bound rows in chunks of kRowChunk, so any t fits the window arrays
  for (int k0 = 0; k0 < t; k0 += kRowChunk) {
    const int rows = t - k0 < kRowChunk ? t - k0 : kRowChunk;
    __syncthreads();                 // the last chunk's windows are read
    // the window of every bound row: counts of the tile's end queries
    for (int e = threadIdx.x; e < 2 * rows; e += blockDim.x) {
      const long long k = k0 + e / 2;
      if (e & 1)
        last_count[e / 2] = count_below(K + k * w, I + k * w, 0, c, lk, li);
      else
        first_count[e / 2] = count_below(K + k * w, I + k * w, 0, c, fk, fi);
    }
    __syncthreads();
    if (!mine) continue;
    for (int kr = 0; kr < rows; ++kr) {
      const T* rk = K + (long long)(k0 + kr) * w;
      const int* ri = I + (long long)(k0 + kr) * w;
      const int lo = first_count[kr], hi = last_count[kr];
      for (int base = 0; base < c; base += bb) {
        const int end = base + bb < c ? base + bb : c;  // the block's end
        if (lo >= end) {             // the whole block is below the tile
          rank += end - base;
          continue;
        }
        if (hi <= base) break;       // this block and the rest are above
        rank += count_below(rk, ri, lo > base ? lo : base,
                            hi < end ? hi : end, qk, qi) - base;
      }
    }
  }
  if (mine) pos[entry * t * w + row * w + j] = rank;
}

template <typename T>
int rank_rows(const T* keys, const int* ids, int* pos, long long batch,
              long long t, long long w, long long c, long long bound_block,
              cudaStream_t stream) {
  // positions are int32: a batch entry holds fewer than 2^31 slots
  if (c > w || t * w >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = batch * t * ((w + kQueryTile - 1) / kQueryTile);
  if (blocks <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  ranks<T><<<blocks, kQueryTile, 0, stream>>>(keys, ids, pos, (int)t, w,
                                              (int)c, (int)bound_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int merge_ranks_f32(const float* keys, const int* ids, int* pos,
                               long long batch, long long t, long long w,
                               long long c, long long bound_block,
                               void* stream) {
  return rank_rows(keys, ids, pos, batch, t, w, c, bound_block,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int merge_ranks_i32(const int* keys, const int* ids, int* pos,
                               long long batch, long long t, long long w,
                               long long c, long long bound_block,
                               void* stream) {
  return rank_rows(keys, ids, pos, batch, t, w, c, bound_block,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int merge_ranks_bf16(const __nv_bfloat16* keys, const int* ids,
                                int* pos, long long batch, long long t,
                                long long w, long long c,
                                long long bound_block, void* stream) {
  return rank_rows(keys, ids, pos, batch, t, w, c, bound_block,
                   static_cast<cudaStream_t>(stream));
}
