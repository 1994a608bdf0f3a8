// Stable row-wise LSD radix sort of a (rows, n) array of float32, int32
// or bf16 keys, any n >= 1: the sorted rows and the int32 stable argsort
// of each row's canonical bits.
//
// Replaces: src/repro/kernels/radix.py radix_sort (pallas_call at :235;
// body _radix_kernel :185 -> _pass_positions :161, keys through
// _sort_ready_bits :133).  The result is the one of the plain version in
// repro_torch/kernels/radix.py, bitwise: the same canonical bits (every
// NaN to all ones, the denormal band and -0.0 onto +0.0) and the same
// stable order.  The plain version repeats the reference's 4-bit passes;
// this kernel counts 8-bit digits, 4 passes for 32-bit keys and 2 for
// bf16's 16 bits.  A row's stable argsort is unique, so any stable LSD
// sort of the same bits gives it, whatever the digit width.
//
// What bounds it on the H100: bytes.  The sort must read x once and
// write the sorted keys and the order once, 12 bytes a key (8 for bf16).
// The TPU kernel keeps a whole row and its one-hot rank tensor in VMEM;
// a 2^18-key row of keys and indices is 2 MB, past a Hopper block's
// 227 KB and a portable cluster's 8 x 227 KB, so every pass goes through
// device memory.  The design keeps that traffic to the least an LSD sort
// of this width needs, about 64 bytes a key in float32 (the histogram
// reads 4; pass 1 reads 4 and writes 8; passes 2-4 read and write 8
// each) and 22 in bf16, in one upfront launch and one launch a pass
// (onesweep: Adinets and Merrill, 2022):
//
//   histogram  one launch reads x once (16-byte loads) and counts every
//              pass's 256 digits of every row: shared-memory atomics,
//              then integer atomicAdds into (rows, passes, 256).
//              Integer sums do not depend on the order;
//   pass       one launch a pass.  Each block takes a ticket from the
//              pass's counter, in (row, tile) order, so a tile only ever
//              waits on tiles that are already running: the look-back
//              cannot deadlock.  For its tile of kTile keys it
//                - loads its warps' runs (16-byte vector loads through
//                  shared memory where aligned),
//                - ranks the keys stably by digit: each warp takes a
//                  contiguous run, 32 keys a round in lane order; a
//                  key's rank is its warp's count of its digit so far
//                  plus its peers in lower lanes (a warp multisplit),
//                - publishes its per-digit count to its status word
//                  (AGGREGATE; tile 0 publishes PREFIX), looks back over
//                  its row's earlier tiles, one thread a digit and
//                  kLook words a load, adding counts until it meets a
//                  PREFIX, and publishes its own PREFIX (decoupled
//                  look-back),
//                - stages the tile in shared memory in digit order and
//                  writes each digit's run to consecutive addresses:
//                  row start of the digit + the earlier tiles' count +
//                  the key's place in the tile's run.
//
// Each pass carries the raw key (2 or 4 bytes) and the int32 index, not
// the canonical bits: the digit is recomputed from the key, so the last
// pass writes the sorted keys and the order straight out (NaN payloads,
// -0.0 and denormals keep their bits), with no gather.  Pass 1 generates
// the index.  Buffers ping-pong between the scratch pair (keys_a, idx_a)
// and the outputs, so the last pass lands in the outputs: x -> a -> out
// -> a -> out, or for bf16 x -> a -> out.
//
// A status word is 64 bits: the count of the digit in the low 32 (a
// count never exceeds n < 2^31) and a tag 2 * pass + 1 (AGGREGATE) or
// 2 * pass + 2 (PREFIX) above it, so one set of words serves every pass
// (a word of an earlier pass reads as not ready) and a load sees the
// count and its flag together.  The status words, the histogram and the
// tickets are one scratch that one cudaMemsetAsync zeroes a call.
#include "network.cuh"

namespace {

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kThreads = 256;          // one thread a digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;             // keys a thread
constexpr int kWarpRun = 32 * kItems;  // a warp's contiguous run
constexpr int kTile = kWarps * kWarpRun;   // 4096 keys a block
constexpr int kHistChunk = 16384;      // keys a histogram block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLook = 8;               // status words a look-back load
constexpr long long kMaxSpins = 1ll << 24;   // look-back loads a tile
static_assert(kThreads == kBins, "the scans take one thread a digit");

// Key traits: the raw word a key moves as and its canonical sortable
// bits (radix.py sort_ready_bits), unsigned.
struct F32Key {
  using U = uint32_t;
  static __device__ __forceinline__ uint32_t ready(uint32_t u) {
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;   // NaN
    const uint32_t b = (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
    // the denormal band and -0.0 fold onto +0.0
    return (b >= 0x7f800000u && b < 0x80800000u) ? 0x80000000u : b;
  }
};

struct I32Key {
  using U = uint32_t;
  static __device__ __forceinline__ uint32_t ready(uint32_t u) {
    return u ^ 0x80000000u;
  }
};

// bf16: the float fold on 16 bits (NaN to 0xffff, the denormal band
// [0x7f80, 0x8080) and -0.0 onto 0x8000)
struct BF16Key {
  using U = uint16_t;
  static __device__ __forceinline__ uint32_t ready(uint16_t raw) {
    const uint32_t u = raw;
    if ((u & 0x7fffu) > 0x7f80u) return 0xffffu;               // NaN
    const uint32_t b = (u & 0x8000u) ? (~u & 0xffffu) : (u ^ 0x8000u);
    return (b >= 0x7f80u && b < 0x8080u) ? 0x8000u : b;
  }
};

// 4 passes for 32-bit keys, 2 for bf16
template <typename K>
constexpr int kPasses = 8 * sizeof(typename K::U) / kBits;

template <typename K>
__device__ __forceinline__ int digit(typename K::U raw, int shift) {
  return static_cast<int>((K::ready(raw) >> shift) & (kBins - 1));
}

__device__ __forceinline__ unsigned long long tag(int pass, bool prefix) {
  return static_cast<unsigned long long>(2 * pass + 1 + (prefix ? 1 : 0))
         << 32;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Element q of a 16-byte vector of U words (little-endian: the lower
// address is the lower half).
template <typename U>
__device__ __forceinline__ U word_of(const uint4& v, int q) {
  const uint32_t w = (&v.x)[q * sizeof(U) / 4];
  return sizeof(U) == 4 ? static_cast<U>(w)
                        : static_cast<U>(w >> (16 * (q & 1)));
}

// A warp's run of kWarpRun words from 16-byte-aligned global memory into
// shared memory, 16 bytes a lane a load.
template <typename U>
__device__ __forceinline__ void warp_copy16(const U* src, U* dst, int lane) {
  constexpr int kVecs = kWarpRun * static_cast<int>(sizeof(U)) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int v = lane; v < kVecs; v += 32) d[v] = s[v];
}

// Count one key's digits of every pass into the block's table.  Plain
// shared atomics: the hardware resolves equal addresses within a warp,
// which rows of one digit (the float exponent byte, ties) hit.
template <typename K>
__device__ __forceinline__ void count_key(unsigned* table, uint32_t bits) {
#pragma unroll
  for (int p = 0; p < kPasses<K>; ++p)
    atomicAdd(&table[p * kBins + ((bits >> (p * kBits)) & (kBins - 1))], 1u);
}

// The digit counts of every pass of one chunk of a row, added into
// hist[row][pass][digit].
template <typename K>
__global__ void __launch_bounds__(kThreads)
    upfront_histogram(const typename K::U* __restrict__ x, long long n,
                      int chunks, unsigned* hist) {
  using U = typename K::U;
  constexpr int P = kPasses<K>;
  constexpr int kPer = 16 / sizeof(U);
  constexpr int kUnroll = 4;   // 16-byte loads in flight a thread
  __shared__ unsigned table[P * kBins];
  const int tid = threadIdx.x;
  for (int i = tid; i < P * kBins; i += kThreads) table[i] = 0;
  __syncthreads();
  const long long row = blockIdx.x / chunks;
  const long long start = (long long)(blockIdx.x % chunks) * kHistChunk;
  const int len = (int)min((long long)kHistChunk, n - start);
  const U* p = x + row * n + start;
  // scalar head up to 16-byte alignment, vectors, scalar tail
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                   sizeof(U));
  head = min(head, len);
  const int vecs = (len - head) / kPer;
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  int v = tid;
  for (; v + (kUnroll - 1) * kThreads < vecs; v += kUnroll * kThreads) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = pv[v + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        count_key<K>(table, K::ready(word_of<U>(w[u], q)));
  }
  for (; v < vecs; v += kThreads) {
    const uint4 w = pv[v];
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      count_key<K>(table, K::ready(word_of<U>(w, q)));
  }
  const int body = head + vecs * kPer;
  for (int s = tid; s < head + (len - body); s += kThreads)
    count_key<K>(table, K::ready(p[s < head ? s : body + (s - head)]));
  __syncthreads();
  unsigned* out = hist + row * P * kBins;
  for (int i = tid; i < P * kBins; i += kThreads)
    if (table[i]) atomicAdd(&out[i], table[i]);
}

// Exclusive scans over the block's 256 threads (one digit each) of two
// values at once.
__device__ __forceinline__ void scan_digits(unsigned a, unsigned b,
                                            unsigned& ea, unsigned& eb,
                                            unsigned (*wsum)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned ya = __shfl_up_sync(kFull, ia, o);
    const unsigned yb = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    wsum[0][warp] = ia;
    wsum[1][warp] = ib;
  }
  __syncthreads();
  unsigned pa = 0, pb = 0;
  for (int w = 0; w < warp; ++w) {
    pa += wsum[0][w];
    pb += wsum[1][w];
  }
  ea = pa + ia - a;
  eb = pb + ib - b;
}

// One stable counting pass of 8-bit digits over one tile; FIRST reads
// x and generates the index.
template <typename K, bool FIRST>
__global__ void __launch_bounds__(kThreads, 3)
    onesweep_pass(const typename K::U* __restrict__ keys_in,
                  const int* __restrict__ idx_in,
                  typename K::U* __restrict__ keys_out,
                  int* __restrict__ idx_out, long long n, int tiles, int pass,
                  const unsigned* __restrict__ hist,
                  unsigned long long* status, int* tickets) {
  using U = typename K::U;
  __shared__ __align__(16) U skey[kTile];
  __shared__ __align__(16) int sidx[kTile];
  __shared__ unsigned whist[kWarps][kBins];
  __shared__ unsigned wsum[2][kWarps];
  __shared__ int tstart[kBins], gdst[kBins];
  __shared__ int sticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sticket = atomicAdd(tickets + pass, 1);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) whist[w][tid] = 0;
  __syncthreads();
  const int ticket = sticket;
  const int tile = ticket % tiles;
  const long long row = ticket / tiles;
  const long long rbase = row * n;
  const int t0 = tile * kTile;
  const int len = (int)min((long long)kTile, n - t0);
  const int shift = pass * kBits;

  // 1. this warp's run into registers in key order: item j of lane l is
  //    key wbase + 32 j + l of the tile
  const int wbase = warp * kWarpRun;
  const U* ksrc = keys_in + rbase + t0 + wbase;
  const int* isrc = FIRST ? nullptr : idx_in + rbase + t0 + wbase;
  U key[kItems];
  int id[kItems];
  if (wbase + kWarpRun <= len && aligned16(ksrc) &&
      (FIRST || aligned16(isrc))) {
    warp_copy16(ksrc, skey + wbase, lane);
    if (!FIRST) warp_copy16(isrc, sidx + wbase, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      key[j] = skey[wbase + 32 * j + lane];
      if (!FIRST) id[j] = sidx[wbase + 32 * j + lane];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (wbase + 32 * j + lane < len) {
        key[j] = ksrc[32 * j + lane];
        if (!FIRST) id[j] = isrc[32 * j + lane];
      }
    }
  }
  if (FIRST) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) id[j] = t0 + wbase + 32 * j + lane;
  }

  // 2. stable ranks within the warp's run, a round of 32 keys at a time
  //    in lane order: a key's rank is the warp's count of its digit in
  //    the earlier rounds plus its peers (the lanes of the round with the
  //    same digit: what __match_any_sync returns) in lower lanes.  The
  //    peers are gathered by an atomicOr of each lane's bit into a word
  //    a digit, which measured faster on the card than the native match
  //    or a ballot a digit bit; the words alias this warp's own run of
  //    sidx, read already.  The round's leader (lowest peer) advances
  //    the warp's count and clears the word.
  unsigned* peers_of = reinterpret_cast<unsigned*>(sidx + wbase);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < kBins; i += 32) peers_of[i] = 0;
  __syncwarp();
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = wbase + 32 * j + lane < len;
    const unsigned active = __ballot_sync(kFull, valid);
    const int d = valid ? digit<K>(key[j], shift) : 0;
    if (valid) atomicOr(&peers_of[d], 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? peers_of[d] : 0u;
    __syncwarp();
    if (valid) {
      const int leader = __ffs(peers) - 1;
      unsigned before = 0;
      if (lane == leader) {
        before = whist[warp][d];
        whist[warp][d] = before + __popc(peers);
        peers_of[d] = 0;
      }
      before = __shfl_sync(active, before, leader);
      rank[j] = (int)(before + __popc(peers & ((1u << lane) - 1)));
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. one thread a digit: the warps' offsets within the tile's run of
  //    the digit, the tile's count, published at once; the digit's start
  //    in the tile and in the row
  const int d = tid;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = whist[w][d];
    whist[w][d] = count;
    count += c;
  }
  unsigned long long* mine =
      status + ((unsigned long long)row * tiles + tile) * kBins + d;
  store_status(mine, tag(pass, tile == 0) | count);
  const unsigned total = hist[(row * kPasses<K> + pass) * kBins + d];
  unsigned tile_start, row_start;
  scan_digits(count, total, tile_start, row_start, wsum);
  tstart[d] = (int)tile_start;
  __syncthreads();

  // 4. the tile in shared memory in digit order
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (wbase + 32 * j + lane < len) {
      const int dj = digit<K>(key[j], shift);
      const int at = tstart[dj] + (int)whist[warp][dj] + rank[j];
      skey[at] = key[j];
      sidx[at] = id[j];
    }
  }

  // 5. decoupled look-back: the digit's count in the row's earlier
  //    tiles, kLook status words loaded at once, summed back from the
  //    nearest until a PREFIX; a word not yet published ends the batch
  //    and is loaded again
  unsigned before = 0;
  if (tile > 0) {
    const unsigned long long ready = tag(pass, false);
    const unsigned long long* col =
        status + (unsigned long long)row * tiles * kBins + d;
    int k = tile - 1;    // the nearest tile not summed yet
    bool done = false;
    for (long long spins = 0; !done; ++spins) {
      // a tile that never publishes is a fault: stop the kernel with an
      // error rather than hold the card
      if (spins > kMaxSpins) __trap();
      unsigned long long w[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q)
        w[q] = k - q >= 0 ? load_status(col + (unsigned long long)(k - q) *
                                                  kBins)
                          : 0ull;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (done || w[q] < ready) break;
        before += (unsigned)w[q];
        --k;
        done = w[q] >= tag(pass, true);
      }
    }
    store_status(mine, tag(pass, true) | (before + count));
  }
  gdst[d] = (int)(row_start + before) - (int)tile_start;
  __syncthreads();

  // 6. out in the tile's digit order: a digit's run of keys lands on
  //    consecutive addresses
  for (int e = tid; e < len; e += kThreads) {
    const U k = skey[e];
    const long long dst = rbase + gdst[digit<K>(k, shift)] + e;
    keys_out[dst] = k;
    idx_out[dst] = sidx[e];
  }
}

// Bytes of the zeroed scratch: the status words, the histogram and the
// tickets.
template <typename K>
long long scratch_need(long long rows, long long tiles) {
  return rows * tiles * kBins * 8 + rows * kPasses<K> * kBins * 4 +
         kPasses<K> * 4;
}

template <typename K>
int radix_rows(const typename K::U* x, typename K::U* sorted, int* order,
               typename K::U* keys_a, int* idx_a, void* scratch,
               long long scratch_bytes, long long rows, long long n,
               cudaStream_t stream) {
  using U = typename K::U;
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = (n + kTile - 1) / kTile;
  const long long chunks = (n + kHistChunk - 1) / kHistChunk;
  const long long need = scratch_need<K>(rows, tiles);
  if (scratch_bytes < need || n >= (1ll << 31) || rows * tiles >= (1ll << 31)
      || rows * chunks >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* hist = reinterpret_cast<unsigned*>(status + rows * tiles * kBins);
  int* tickets = reinterpret_cast<int*>(hist + rows * kPasses<K> * kBins);
  cudaError_t err = cudaMemsetAsync(scratch, 0, need, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  upfront_histogram<K><<<(unsigned)(rows * chunks), kThreads, 0, stream>>>(
      x, n, (int)chunks, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p = 0; p < kPasses<K>; ++p) {
    // pass p writes the outputs when p is odd, the scratch pair else
    const U* kin = p == 0 ? x : (p & 1) ? keys_a : sorted;
    const int* iin = p == 0 ? nullptr : (p & 1) ? idx_a : order;
    U* kout = (p & 1) ? sorted : keys_a;
    int* iout = (p & 1) ? order : idx_a;
    if (p == 0)
      onesweep_pass<K, true><<<(unsigned)(rows * tiles), kThreads, 0, stream>>>(
          kin, iin, kout, iout, n, (int)tiles, p, hist, status, tickets);
    else
      onesweep_pass<K, false><<<(unsigned)(rows * tiles), kThreads, 0,
                                        stream>>>(
          kin, iin, kout, iout, n, (int)tiles, p, hist, status, tickets);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int radix_sort_f32(const float* x, float* sorted, int* order,
                              float* keys_a, int* idx_a, void* scratch,
                              long long scratch_bytes, long long rows,
                              long long n, void* stream) {
  return radix_rows<F32Key>(
      reinterpret_cast<const uint32_t*>(x), reinterpret_cast<uint32_t*>(sorted),
      order, reinterpret_cast<uint32_t*>(keys_a), idx_a, scratch,
      scratch_bytes, rows, n, static_cast<cudaStream_t>(stream));
}

extern "C" int radix_sort_i32(const int* x, int* sorted, int* order,
                              int* keys_a, int* idx_a, void* scratch,
                              long long scratch_bytes, long long rows,
                              long long n, void* stream) {
  return radix_rows<I32Key>(
      reinterpret_cast<const uint32_t*>(x), reinterpret_cast<uint32_t*>(sorted),
      order, reinterpret_cast<uint32_t*>(keys_a), idx_a, scratch,
      scratch_bytes, rows, n, static_cast<cudaStream_t>(stream));
}

extern "C" int radix_sort_bf16(const __nv_bfloat16* x, __nv_bfloat16* sorted,
                               int* order, __nv_bfloat16* keys_a, int* idx_a,
                               void* scratch, long long scratch_bytes,
                               long long rows, long long n, void* stream) {
  return radix_rows<BF16Key>(
      reinterpret_cast<const uint16_t*>(x), reinterpret_cast<uint16_t*>(sorted),
      order, reinterpret_cast<uint16_t*>(keys_a), idx_a, scratch,
      scratch_bytes, rows, n, static_cast<cudaStream_t>(stream));
}
