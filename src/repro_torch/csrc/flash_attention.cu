// Blocked causal attention with an online softmax (flash attention):
// out = softmax(q k^T / sqrt(d), masked) v for each (batch, q head),
// GQA (kv head = q head / (Hq / Hkv)), an optional sliding window, f32
// or bf16 in and out, f32 inside.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention
// (pallas_call at :105, body _fa_kernel :31) -- the LM's prefill.  The
// arithmetic is the reference's: scores = (q . k) * sm_scale in f32,
// masked entries set to -1e30, m_new = max(m, rowmax(s)),
// p = exp(s - m_new) (0 where masked), alpha = exp(m - m_new),
// l = l * alpha + rowsum(p), acc = acc * alpha + p v, and at the end
// acc / (l == 0 ? 1 : l).  Query i sits at position i + (Sk - Sq): the
// queries are right-aligned to the keys, as in the reference kernel.
//
// Layout.  The TPU walks a (batch*heads, q blocks, kv blocks) grid with
// the kv axis innermost and keeps (m, l, acc) in VMEM scratch across
// it.  Here one block owns one (batch*head, 64-query tile) and loops
// over the kv tiles itself; that loop takes the place of the sequential
// kv grid axis.  The Q tile (as f32) and one 32-key K and V tile live
// in shared memory: (64 + 32) rows of d + 4 floats plus 32 rows of d
// floats, 132,608 bytes at d = 256, so the largest head_dim in the repo
// fits the 227 KB a block may use.  Four threads share a query row: each
// holds 8 of the row's 32 scores and a quarter of its d accumulators
// (d / 4 floats in registers), and the row's max and sum are taken
// across the four lanes with shuffles.  The probabilities reach the
// P.V product by shuffles too, so no score tile goes to shared memory.
// The d + 4 row pitch keeps 16-byte loads aligned and puts the rows that
// one warp reads at once in distinct banks.
//
// Skipped tiles.  A kv tile that lies wholly past the causal edge of
// every query of the block, or wholly before all their windows, is not
// visited.  Under the -1e30 trick such a tile gives p = 0 for every
// entry and m_new = m, so alpha = exp(0) = 1: visiting it would change
// no bit of (m, l, acc).  So the skip is exact, and the kernel does the
// causal half (or the window's band) of the work.
//
// What bounds it on the H100.  At prefill shapes attention does
// 4 * B * Hq * Sq * Sk * d / 2 flops (causal) on inputs of a few MB: it
// is bounded by tensor-core flops (989 TFLOP/s bf16 dense).  This
// kernel is the simple one: it runs on the CUDA cores in f32 (67
// TFLOP/s at most) and reads its operands from shared memory for every
// multiply-add, so it is far from that bound.  wgmma, TMA and warp
// specialisation are later work.
#include <cuda_bf16.h>

#include "network.cuh"

namespace {

constexpr int BQ = 64;        // queries a block
constexpr int BK = 32;        // keys a step
constexpr int THREADS = 256;  // four a query row
constexpr int SPT = BK / 4;   // scores a thread holds each step
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BQ + BK) * (D + 4) + BK * D);
}

// Copy rows [r0, r0 + rows) of a (seq, D) matrix into shared memory as
// f32 with row pitch ld; rows at or past seq are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int r0, int rows, int seq) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] =
        r0 + r < seq ? to_f32(src[(long long)(r0 + r) * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
              int sq, int sk, float scale, int causal, int window) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 4;
  constexpr int ACC = D / 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* ks = qs + BQ * LD;                       // BK x LD
  float* vs = ks + BK * LD;                       // BK x D

  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 2;  // this thread's query in the tile
  const int sub = threadIdx.x & 3;   // its quarter of the row
  const int off = sk - sq;           // queries right-aligned to the keys
  const T* kb = k + (long long)kvh * sk * D;
  const T* vb = v + (long long)kvh * sk * D;

  load_rows<T, D>(qs, LD, q + (long long)bh * sq * D, q0, BQ, sq);

  // the kv tiles any query of this block can see (see "Skipped tiles")
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + BQ, sq) - 1 + off;
  const int k_end = causal ? min(sk, qpos_hi + 1) : sk;
  int k_begin = window >= 0 ? max(0, qpos_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const int qpos = q0 + row + off;
  float m = NEG, l = 0.f;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile is consumed (and Q is in place)
    load_rows<T, D>(ks, LD, kb, k0, BK, sk);
    load_rows<T, D>(vs, D, vb, k0, BK, sk);
    __syncthreads();

    // scores of keys k0 + sub + 4 * jj against this thread's query
    float s[SPT];
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) s[jj] = 0.f;
    const float4* qr = reinterpret_cast<const float4*>(qs + row * LD);
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = qr[c];
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const float4 b =
            reinterpret_cast<const float4*>(ks + (sub + 4 * jj) * LD)[c];
        s[jj] = fmaf(a.x, b.x, s[jj]);
        s[jj] = fmaf(a.y, b.y, s[jj]);
        s[jj] = fmaf(a.z, b.z, s[jj]);
        s[jj] = fmaf(a.w, b.w, s[jj]);
      }
    }
    bool ok[SPT];
    float tile_max = NEG;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int kpos = k0 + sub + 4 * jj;
      ok[jj] = kpos < sk && (!causal || kpos <= qpos) &&
               (window < 0 || kpos > qpos - window);
      s[jj] = ok[jj] ? s[jj] * scale : NEG;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    float row_sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      s[jj] = ok[jj] ? expf(s[jj] - m_new) : 0.f;
      row_sum += s[jj];
    }
    row_sum += __shfl_xor_sync(FULL, row_sum, 1);
    row_sum += __shfl_xor_sync(FULL, row_sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] *= alpha;

    // acc += p v: key sub' + 4 * jj's probability comes from lane sub'
    // of this row's four; this thread owns columns 16 * c4 + 4 * sub + e
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
#pragma unroll
      for (int from = 0; from < 4; ++from) {
        const float p = __shfl_sync(FULL, s[jj], (lane & ~3) | from);
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (from + 4 * jj) * D);
#pragma unroll
        for (int c4 = 0; c4 < D / 16; ++c4) {
          const float4 b = vr[4 * c4 + sub];
          acc[4 * c4 + 0] = fmaf(p, b.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, b.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, b.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, b.w, acc[4 * c4 + 3]);
        }
      }
    }
  }

  if (q0 + row < sq) {
    const float denom = l == 0.f ? 1.f : l;
    T* o = out + ((long long)bh * sq + q0 + row) * D;
#pragma unroll
    for (int c4 = 0; c4 < D / 16; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(o + 16 * c4 + 4 * sub + e, acc[4 * c4 + e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* out, long long b,
                     long long hq, long long hkv, long long sq, long long sk,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                  static_cast<unsigned>(b * hq));
  fa_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, (int)hq, (int)hkv, (int)sq, (int)sk, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
int attend(const T* q, const T* k, const T* v, T* out, long long b,
           long long hq, long long hkv, long long sq, long long sk,
           long long d, float scale, int causal, int window,
           cudaStream_t stream) {
  if (b * hq <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv || b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (d) {
    case 16: err = launch_d<T, 16>(q, k, v, out, b, hq, hkv, sq, sk, scale,
                                   causal, window, stream); break;
    case 32: err = launch_d<T, 32>(q, k, v, out, b, hq, hkv, sq, sk, scale,
                                   causal, window, stream); break;
    case 64: err = launch_d<T, 64>(q, k, v, out, b, hq, hkv, sq, sk, scale,
                                   causal, window, stream); break;
    case 128: err = launch_d<T, 128>(q, k, v, out, b, hq, hkv, sq, sk, scale,
                                     causal, window, stream); break;
    case 256: err = launch_d<T, 256>(q, k, v, out, b, hq, hkv, sq, sk, scale,
                                     causal, window, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q (b, hq, sq, d), k and v (b, hkv, sk, d), out like q; all contiguous.
// d is one of 16, 32, 64, 128, 256; window < 0 means no window.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, long long b,
                                   long long hq, long long hkv, long long sq,
                                   long long sk, long long d, float scale,
                                   int causal, int window, void* stream) {
  return attend(q, k, v, out, b, hq, hkv, sq, sk, d, scale, causal, window,
                static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, long long b,
                                    long long hq, long long hkv, long long sq,
                                    long long sk, long long d, float scale,
                                    int causal, int window, void* stream) {
  return attend(q, k, v, out, b, hq, hkv, sq, sk, d, scale, causal, window,
                static_cast<cudaStream_t>(stream));
}
