// Stable row-wise LSD radix sort of a (rows, n) array of float32, int32
// or bf16 keys, any n >= 1: the sorted rows and the int32 stable argsort.
// bf16 keys are 16-bit keys: 4 passes of 4 bits instead of 8, as the
// reference's key_bits has it (radix.py:79).
//
// Replaces: src/repro/kernels/radix.py radix_sort (pallas_call at :235;
// body _radix_kernel :185 -> _pass_positions :161, keys through
// _sort_ready_bits :133).  The result is the one of the plain version
// in repro_torch/kernels/radix.py, bitwise: the same canonical bits
// (every NaN to all ones, the denormal band and -0.0 onto +0.0), the
// same 8 stable counting passes of 4 bits, and the sorted keys gathered
// from the original x through the order, so NaN payloads, -0.0 and
// denormals keep their bits.
//
// Design.  The TPU kernel keeps a whole row and its (n, 16) one-hot
// rank tensor in VMEM and runs every pass there.  A 2^16-key row of
// bits and indices is 512 KiB, past a Hopper block's 227 KB, so each
// pass is two launches over tiles of kTile keys (one block a tile):
//
//   histogram  each block counts the 16 digits of its tile into
//              counts[row][digit][tile] (warp-aggregated shared atomics:
//              integer sums, so the counts do not depend on the order);
//   scatter    each block reads the counts of its row, derives where
//              each digit of its tile starts in the output row (all
//              smaller digits of the row, then this digit in earlier
//              tiles), ranks its keys stably in shared memory and writes
//              (bits, index) there.
//
// Stability is the point: the order channel carries every payload, and
// ties are common (Zipf keys take 37 values).  A key's rank is never
// taken from an atomic.  Thread t holds the 16 consecutive keys
// 16t..16t+15 of its tile and counts their digits in registers (each
// key's rank within its thread is the count before it); an exclusive
// scan over (digit, thread) then gives each key its position in the
// tile's stable digit order.  Keys are staged in shared memory at that
// position and written out in tile order, so a run of one digit lands
// on consecutive addresses.
//
// The first pass computes the canonical bits from x itself, and its
// index channel is the position; the last pass writes the order and
// gathers the sorted keys from x instead of writing bits.  Buffers
// ping-pong between (bits_a, idx_a) and (bits_b, order).
//
// What bounds it on the H100.  The sort must read x once and write the
// keys and the order once, 12 bytes a key.  This design moves about
// 20 bytes a key a pass (the histogram reads 4; the scatter reads 8 and
// writes 8), some 84 MB a pass at (64, 65536), so device-memory bytes
// of the 8 passes bound it, plus 16 launches.  Fewer passes over
// device memory (onesweep with decoupled look-back, or a cluster that
// holds a row) are a later change.
#include "network.cuh"

using namespace repro;

namespace {

constexpr int kBits = 4;
constexpr int kBins = 1 << kBits;
// 8 passes for 32-bit keys, 4 for bf16's 16 (radix.py key_bits)
template <typename T>
constexpr int kPasses = 8 * sizeof(T) / kBits;
constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;   // 4096 keys a block
constexpr int kWarps = kThreads / 32;
// shared-memory index with one pad word every 32: thread t's 16
// consecutive keys (stride 16) and a warp's consecutive keys both fall
// on distinct banks
constexpr int kPadded = kTile + kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

// Keys in tile `tile` of a row of n: kTile, or fewer in the last one.
__device__ __forceinline__ int tile_len(long long n, int tile) {
  const long long rest = n - (long long)tile * kTile;
  return rest < kTile ? (int)rest : kTile;
}

// The canonical sortable bits (radix.py sort_ready_bits), unsigned.
__device__ __forceinline__ uint32_t sort_ready(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;     // NaN
  const uint32_t b = (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
  // the denormal band and -0.0 fold onto +0.0
  return (b >= 0x7f800000u && b < 0x80800000u) ? 0x80000000u : b;
}

__device__ __forceinline__ uint32_t sort_ready(int v) {
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}

// bf16: the same fold on 16 bits, in the low half of the word (NaN to
// 0xffff, the denormal band [0x7f80, 0x8080) and -0.0 onto 0x8000).
__device__ __forceinline__ uint32_t sort_ready(__nv_bfloat16 v) {
  const uint32_t u = __bfloat16_as_ushort(v);
  if ((u & 0x7fffu) > 0x7f80u) return 0xffffu;                 // NaN
  const uint32_t b = (u & 0x8000u) ? (~u & 0xffffu) : (u ^ 0x8000u);
  return (b >= 0x7f80u && b < 0x8080u) ? 0x8000u : b;
}

__device__ __forceinline__ int digit_of(uint32_t b, int shift) {
  return static_cast<int>((b >> shift) & (kBins - 1));
}

// Digit counts of one tile of this pass's input.
template <typename T, bool FIRST>
__global__ void __launch_bounds__(kThreads)
    histogram(const T* x, const uint32_t* bits, long long n, int tiles,
              int shift, int* counts) {
  __shared__ int hist[kBins];
  const int tile = blockIdx.x % tiles;
  const long long row = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kBins) hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = row * n + (long long)tile * kTile;
  const int len = tile_len(n, tile);
  for (int e0 = 0; e0 < len; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const bool valid = e < len;
    const unsigned active = __ballot_sync(kFull, valid);
    if (valid) {
      const uint32_t b = FIRST ? sort_ready(x[base + e]) : bits[base + e];
      const int d = digit_of(b, shift);
      const unsigned peers = __match_any_sync(active, d);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
  }
  __syncthreads();
  if (threadIdx.x < kBins)
    counts[(row * kBins + threadIdx.x) * tiles + tile] = hist[threadIdx.x];
}

// One stable counting pass over one tile: rank in shared memory, then
// write (bits, index) -- or, in the last pass, (x[index], index) -- to
// the output row.
template <typename T, bool FIRST, bool LAST>
__global__ void __launch_bounds__(kThreads)
    scatter(const T* x, const uint32_t* bits_in, const int* idx_in,
            uint32_t* bits_out, int* idx_out, T* sorted, long long n,
            int tiles, int shift, const int* counts) {
  // sbits doubles as the (digit, thread) count table between loads
  __shared__ uint32_t sbits[kPadded];
  __shared__ int sidx[kPadded];
  __shared__ int total[kBins], before[kBins], gstart[kBins], tstart[kBins];
  __shared__ int wsum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x % tiles;
  const long long row = blockIdx.x / tiles;
  const long long rbase = row * n;
  const int t0 = tile * kTile;
  const int len = tile_len(n, tile);

  // 1. the tile, coalesced, into shared memory; the row's digit counts
  for (int e = tid; e < len; e += kThreads) {
    if (FIRST) {
      sbits[padded(e)] = sort_ready(x[rbase + t0 + e]);
      sidx[padded(e)] = t0 + e;
    } else {
      sbits[padded(e)] = bits_in[rbase + t0 + e];
      sidx[padded(e)] = idx_in[rbase + t0 + e];
    }
  }
  if (tid < kBins) {
    const int* c = counts + (row * kBins + tid) * tiles;
    int tot = 0, pre = 0;
    for (int k = 0; k < tiles; ++k) {
      tot += c[k];
      if (k < tile) pre += c[k];
    }
    total[tid] = tot;
    before[tid] = pre;
  }
  __syncthreads();

  // 2. this thread's 16 consecutive keys; digit counts packed 8 bits a
  //    digit in two words (at most 16 a digit), each key's rank within
  //    the thread read off before its own count
  uint32_t b[kPerThread];
  int id[kPerThread], r[kPerThread];
  unsigned long long lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = tid * kPerThread + j;
    r[j] = -1;
    if (e < len) {
      b[j] = sbits[padded(e)];
      id[j] = sidx[padded(e)];
      const int d = digit_of(b[j], shift);
      const int sh = (d & 7) * 8;
      if (d < 8) {
        r[j] = (int)((lo >> sh) & 0xff);
        lo += 1ull << sh;
      } else {
        r[j] = (int)((hi >> sh) & 0xff);
        hi += 1ull << sh;
      }
    }
  }
  if (tid < kBins) {
    int g = before[tid];
    for (int d = 0; d < tid; ++d) g += total[d];
    gstart[tid] = g;
  }
  __syncthreads();                       // sbits is free: the count table

  uint32_t* cnt = sbits;                 // cnt[padded(d * kThreads + t)]
#pragma unroll
  for (int d = 0; d < kBins; ++d)
    cnt[padded(d * kThreads + tid)] =
        (uint32_t)(((d < 8 ? lo : hi) >> ((d & 7) * 8)) & 0xff);
  __syncthreads();

  // 3. exclusive scan of the count table in (digit, thread) order:
  //    thread t owns entries 16t..16t+15
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) own += cnt[padded(tid * kPerThread + j)];
  uint32_t incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = (int)incl;
  __syncthreads();
  uint32_t run = incl - own;
  for (int w = 0; w < warp; ++w) run += (uint32_t)wsum[w];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = padded(tid * kPerThread + j);
    const uint32_t c = cnt[p];
    cnt[p] = run;
    run += c;
  }
  __syncthreads();

  // 4. each key's position in the tile's stable digit order
  int pos[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    pos[j] = -1;
    if (r[j] >= 0) {
      const int d = digit_of(b[j], shift);
      pos[j] = (int)cnt[padded(d * kThreads + tid)] + r[j];
    }
  }
  if (tid < kBins) tstart[tid] = (int)cnt[padded(tid * kThreads)];
  __syncthreads();                       // the count table is free again

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (pos[j] >= 0) {
      sbits[padded(pos[j])] = b[j];
      sidx[padded(pos[j])] = id[j];
    }
  }
  __syncthreads();

  // 5. out in tile order: a digit's keys go to consecutive addresses
  for (int e = tid; e < len; e += kThreads) {
    const uint32_t v = sbits[padded(e)];
    const int i = sidx[padded(e)];
    const int d = digit_of(v, shift);
    const long long dst = rbase + gstart[d] + (e - tstart[d]);
    idx_out[dst] = i;
    if (LAST)
      sorted[dst] = x[rbase + i];
    else
      bits_out[dst] = v;
  }
}

template <typename T>
int radix_rows(const T* x, T* sorted, int* order, uint32_t* bits_a,
               int* idx_a, uint32_t* bits_b, int* counts, long long rows,
               long long n, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (int)((n + kTile - 1) / kTile);
  const long long blocks = rows * tiles;
  uint32_t* bits[2] = {bits_a, bits_b};
  int* idx[2] = {idx_a, order};
  for (int p = 0; p < kPasses<T>; ++p) {
    const int shift = p * kBits;
    const int in = (p + 1) & 1, out = p & 1;  // pass p writes buffer p % 2
    if (p == 0)
      histogram<T, true><<<blocks, kThreads, 0, stream>>>(
          x, nullptr, n, tiles, shift, counts);
    else
      histogram<T, false><<<blocks, kThreads, 0, stream>>>(
          x, bits[in], n, tiles, shift, counts);
    if (p == 0)
      scatter<T, true, false><<<blocks, kThreads, 0, stream>>>(
          x, nullptr, nullptr, bits[out], idx[out], nullptr, n, tiles, shift,
          counts);
    else if (p < kPasses<T> - 1)
      scatter<T, false, false><<<blocks, kThreads, 0, stream>>>(
          x, bits[in], idx[in], bits[out], idx[out], nullptr, n, tiles,
          shift, counts);
    else
      scatter<T, false, true><<<blocks, kThreads, 0, stream>>>(
          x, bits[in], idx[in], nullptr, order, sorted, n, tiles, shift,
          counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int radix_sort_f32(const float* x, float* sorted, int* order,
                              int* bits_a, int* idx_a, int* bits_b,
                              int* counts, long long rows, long long n,
                              void* stream) {
  return radix_rows(x, sorted, order, reinterpret_cast<uint32_t*>(bits_a),
                    idx_a, reinterpret_cast<uint32_t*>(bits_b), counts, rows,
                    n, static_cast<cudaStream_t>(stream));
}

extern "C" int radix_sort_i32(const int* x, int* sorted, int* order,
                              int* bits_a, int* idx_a, int* bits_b,
                              int* counts, long long rows, long long n,
                              void* stream) {
  return radix_rows(x, sorted, order, reinterpret_cast<uint32_t*>(bits_a),
                    idx_a, reinterpret_cast<uint32_t*>(bits_b), counts, rows,
                    n, static_cast<cudaStream_t>(stream));
}

extern "C" int radix_sort_bf16(const __nv_bfloat16* x, __nv_bfloat16* sorted,
                               int* order, int* bits_a, int* idx_a,
                               int* bits_b, int* counts, long long rows,
                               long long n, void* stream) {
  return radix_rows(x, sorted, order, reinterpret_cast<uint32_t*>(bits_a),
                    idx_a, reinterpret_cast<uint32_t*>(bits_b), counts, rows,
                    n, static_cast<cudaStream_t>(stream));
}
