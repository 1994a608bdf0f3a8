// Blocked causal attention with an online softmax (flash attention):
// out = softmax(q k^T / sqrt(d), masked) v for each (batch, q head),
// GQA (kv head = q head / (Hq / Hkv)), an optional sliding window, f32
// or bf16 in and out.  Two kernels: fa_wgmma for bf16 on the tensor
// cores (the serving dtype), and fa_simt for f32 on the CUDA cores (the
// 1e-5 path of the smoke configuration and the tests).
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
// The TPU walks a (batch*heads, q blocks, kv blocks) grid with the kv
// axis innermost and keeps (m, l, acc) in VMEM scratch across it.  Here
// a block owns one (batch*head, query tile) and loops over the kv tiles
// itself; that loop takes the place of the sequential kv grid axis.
//
// Skipped tiles.  A kv tile that lies wholly past the causal edge of
// every query of the block, or wholly before all their windows, is not
// visited.  Under the -1e30 trick such a tile gives p = 0 for every
// entry and m_new = m, so alpha = exp(0) = 1: visiting it would change
// no bit of (m, l, acc).  So the skip is exact, and the kernels do the
// causal half (or the window's band) of the work.  fa_wgmma also skips
// a tile that masks all 64 rows of one warpgroup.
//
// fa_wgmma (bf16).  What bounds attention on the H100 at prefill shapes
// is tensor-core flops: 4 * B * Hq * Sq * Sk * d / 2 (causal) on inputs
// of a few tens of MB, 989 TFLOP/s bf16 dense.  So both products run on
// Hopper's warpgroup tensor-core instruction, wgmma.mma_async, with f32
// accumulators:
//   * a block owns 128 queries as two warpgroups of 64 rows; the Q tile
//     stays in shared memory;
//   * K and V tiles of BK keys (64 at d = 256, 128 at d <= 128) arrive
//     by cp.async in a ring of two stages: the next tile's copy is in
//     flight while this tile's products run.  Every tile is stored in
//     the 128-byte swizzled layout wgmma's descriptors read (column
//     blocks of 64 values, 16-byte chunk c of row r at c ^ (r % 8)), so
//     the tensor cores read shared memory without bank conflicts;
//   * S = Q K^T: wgmma m64nBKk16, both operands K-major from shared
//     memory (a k-step is 32 bytes into a 128-byte row);
//   * O += P V: wgmma m64n(d)k16 with P from registers -- the S
//     accumulators of two adjacent 8-key column blocks are exactly the A
//     fragment of a 16-key k-step -- and V from shared memory as an
//     MN-major (transposed) operand, so V needs no transpose;
//   * the row max and sum across the quad of threads that share a row
//     by two shuffles; exp2 of scores pre-scaled by log2(e).
// At d = 256: Q 128 x 256 x 2 B = 64 KiB, two stages of K and V 128
// KiB, 193 KiB of the 227 KiB a block may use; O is 64 x 256 f32 a
// warpgroup, 128 registers a thread.  A bf16 head_dim below 64 is
// zero-padded to 64 by the wrapper.  The reference multiplies P V in
// f32.  P rounded once to bf16 missed the kernel's bound on the card (2
// bf16 ulps of the output where terms cancel), so P goes in as two bf16
// halves, hi + lo, two products on the same V tile: P V costs twice the
// tensor-core work of Q K^T, and P keeps ~16 of its 24 bits.  The sum l
// is over the f32 p.  The products run one after the other within a
// warpgroup (no ping-pong, no producer warp); the two warpgroups of a
// block overlap one's softmax with the other's products.
//
// fa_simt (f32) is the simple first kernel: one block a 64-query tile,
// 32-key tiles, f32 FMAs on the CUDA cores.  The Q tile and one K and V
// tile live in shared memory: (64 + 32) rows of d + 4 floats plus 32
// rows of d floats, 132,608 bytes at d = 256.  Four threads share a
// query row: each holds 8 of the row's 32 scores and a quarter of its d
// accumulators, and the row's max and sum are taken across the four
// lanes with shuffles; the probabilities reach the P.V product by
// shuffles too.  It reads its operands from shared memory for every
// multiply-add and is far from the card's bounds.
#include <cuda_bf16.h>

#include <type_traits>

#include "network.cuh"

namespace {

// ---------------------------------------------------------------------------
// fa_simt: f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // queries a block
constexpr int BK = 32;        // keys a step
constexpr int THREADS = 256;  // four a query row
constexpr int SPT = BK / 4;   // scores a thread holds each step
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BQ + BK) * (D + 4) + BK * D);
}

// Copy rows [r0, r0 + rows) of a (seq, D) matrix into shared memory
// with row pitch ld; rows at or past seq are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int r0, int rows,
                                          int seq) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r0 + r < seq ? src[(long long)(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    fa_simt(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int hq,
            int hkv, int sq, int sk, float scale, int causal, int window) {
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
  const float* kb = k + (long long)kvh * sk * D;
  const float* vb = v + (long long)kvh * sk * D;

  load_rows<D>(qs, LD, q + (long long)bh * sq * D, q0, BQ, sq);

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
    load_rows<D>(ks, LD, kb, k0, BK, sk);
    load_rows<D>(vs, D, vb, k0, BK, sk);
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
    float* o = out + ((long long)bh * sq + q0 + row) * D;
#pragma unroll
    for (int c4 = 0; c4 < D / 16; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[16 * c4 + 4 * sub + e] = acc[4 * c4 + e] / denom;
  }
}

template <int D>
cudaError_t launch_simt(const float* q, const float* k, const float* v,
                        float* out, long long b, long long hq, long long hkv,
                        long long sq, long long sk, float scale, int causal,
                        int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                  static_cast<unsigned>(b * hq));
  fa_simt<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, (int)hq, (int)hkv, (int)sq, (int)sk, scale, causal,
      window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fa_wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MQ = 128;               // queries a block: two warpgroups
constexpr int MTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as packed bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// c (64 x 64 f32, 32 a thread) += A (64 x 16, K-major, shared) *
// B (64 x 16, K-major, shared); scale_d 0 overwrites c.
__device__ __forceinline__ void wgmma_ss_n64(float (&c)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// c (64 x 128 f32, 64 a thread) += A (64 x 16, K-major, shared) *
// B (128 x 16, K-major, shared); scale_d 0 overwrites c.
__device__ __forceinline__ void wgmma_ss_n128(float (&c)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// c (64 x 64 f32, 32 a thread) += A (64 x 16 bf16, registers: the
// mma.m16n8k16 A fragment of each warp's 16 rows) * B (16 x 64, MN-major
// in shared memory: trans-b).
__device__ __forceinline__ void wgmma_rs_n64(float (&c)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c (64 x 128 f32, 64 a thread) += A (64 x 16 bf16, registers: the
// mma.m16n8k16 A fragment of each warp's 16 rows) * B (16 x 128, MN-major
// in shared memory: trans-b).
__device__ __forceinline__ void wgmma_rs_n128(float (&c)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c (64 x 256 f32, 128 a thread) += A (64 x 16 bf16, registers: the
// mma.m16n8k16 A fragment of each warp's 16 rows) * B (16 x 256, MN-major
// in shared memory: trans-b).
__device__ __forceinline__ void wgmma_rs_n256(float (&c)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63]),
        "+f"(c[64]), "+f"(c[65]), "+f"(c[66]), "+f"(c[67]),
        "+f"(c[68]), "+f"(c[69]), "+f"(c[70]), "+f"(c[71]),
        "+f"(c[72]), "+f"(c[73]), "+f"(c[74]), "+f"(c[75]),
        "+f"(c[76]), "+f"(c[77]), "+f"(c[78]), "+f"(c[79]),
        "+f"(c[80]), "+f"(c[81]), "+f"(c[82]), "+f"(c[83]),
        "+f"(c[84]), "+f"(c[85]), "+f"(c[86]), "+f"(c[87]),
        "+f"(c[88]), "+f"(c[89]), "+f"(c[90]), "+f"(c[91]),
        "+f"(c[92]), "+f"(c[93]), "+f"(c[94]), "+f"(c[95]),
        "+f"(c[96]), "+f"(c[97]), "+f"(c[98]), "+f"(c[99]),
        "+f"(c[100]), "+f"(c[101]), "+f"(c[102]), "+f"(c[103]),
        "+f"(c[104]), "+f"(c[105]), "+f"(c[106]), "+f"(c[107]),
        "+f"(c[108]), "+f"(c[109]), "+f"(c[110]), "+f"(c[111]),
        "+f"(c[112]), "+f"(c[113]), "+f"(c[114]), "+f"(c[115]),
        "+f"(c[116]), "+f"(c[117]), "+f"(c[118]), "+f"(c[119]),
        "+f"(c[120]), "+f"(c[121]), "+f"(c[122]), "+f"(c[123]),
        "+f"(c[124]), "+f"(c[125]), "+f"(c[126]), "+f"(c[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async's writes are the generic proxy's; wgmma reads shared memory
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Rows [r0, r0 + ROWS) of a (seq, D) matrix into shared memory at byte
// address dst, by cp.async, in the 128-byte swizzled layout wgmma reads:
// D / 64 column blocks of ROWS rows x 128 bytes, the 16-byte chunk c of
// row r at chunk c ^ (r % 8).  Rows at or past seq are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_swizzled(uint32_t dst, const bf16* src,
                                              int r0, int seq) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += MTHREADS) {
    const int r = i / CHUNKS, cc = i % CHUNKS;
    const bool ok = r0 + r < seq;
    const uint32_t d = dst + (cc >> 3) * ROWS * 128 + r * 128 +
                       (((cc & 7) ^ (r & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src + (long long)(ok ? r0 + r : 0) * D + cc * 8),
                 "r"(ok ? 16 : 0)
                 : "memory");
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&c)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(c, a, b, scale_d);
  else
    wgmma_ss_n128(c, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&c)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64)
    wgmma_rs_n64(c, a, b);
  else if constexpr (N == 128)
    wgmma_rs_n128(c, a, b);
  else
    wgmma_rs_n256(c, a, b);
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, 1)
    fa_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int hq,
             int hkv, int sq, int sk, float scale, int causal, int window) {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int BK = D > 128 ? 64 : 128;  // keys a step
  constexpr int NS = BK / 2;              // S accumulators a thread
  constexpr int NO = D / 2;               // O accumulators a thread
  constexpr int KSTEPS = BK / 16;
  constexpr uint32_t KV = BK * D * 2;     // bytes of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv0 = qs + MQ * D * 2;  // stage s: K at kv0 + 2 s KV, V after

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // longest tiles first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // this thread's warpgroup: 64 query rows
  const int off = sk - sq;   // queries right-aligned to the keys
  const bf16* kb = k + (long long)kvh * sk * D;
  const bf16* vb = v + (long long)kvh * sk * D;

  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + MQ, sq) - 1 + off;
  const int k_end = causal ? min(sk, qpos_hi + 1) : sk;
  int k_begin = window >= 0 ? max(0, qpos_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  // the warpgroup's rows sit at positions g_lo..g_lo+63; this thread's
  // two rows, a and a + 8, as the accumulator fragments lay them out
  const int g_lo = q0 + wg * 64 + off, g_hi = g_lo + 63;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int qpos_a = row_a + off;

  load_swizzled<D, MQ>(qs, q + (long long)bh * sq * D, q0, sq);
  if (k_begin < k_end) {
    load_swizzled<D, BK>(kv0, kb, k_begin, sk);
    load_swizzled<D, BK>(kv0 + KV, vb, k_begin, sk);
  }
  cp_async_commit();

  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const float c2 = scale * LOG2E;  // scores in log2 units

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, stage ^= 1) {
    if (k0 + BK < k_end) {  // the next tile, into the other stage
      const uint32_t nxt = kv0 + (stage ^ 1) * 2 * KV;
      load_swizzled<D, BK>(nxt, kb, k0 + BK, sk);
      load_swizzled<D, BK>(nxt + KV, vb, k0 + BK, sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    const bool dead = (causal && k0 > g_hi) ||
                      (window >= 0 && k0 + BK - 1 <= g_lo - window);
    if (!dead) {
      const uint32_t ks = kv0 + stage * 2 * KV, vs = ks + KV;

      // S = Q K^T: A the warpgroup's 64 Q rows, B the tile's K rows,
      // both K-major; k-step kk is 32 bytes into column block kk / 4
      float s[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(s,
                     smem_desc(qs + (kk >> 2) * MQ * 128 + wg * 64 * 128 +
                                   (kk & 3) * 32,
                               16, 1024),
                     smem_desc(ks + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
                               1024),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();

      // mask, scale, online softmax; s[4 j + e] is row a (e < 2) or
      // a + 8, key k0 + 8 j + 2 (lane % 4) + (e & 1)
      const bool edge = k0 + BK > sk ||
                        (causal && k0 + BK - 1 > g_lo) ||
                        (window >= 0 && k0 <= g_hi - window);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int e = i & 3;
        bool ok = true;
        if (edge) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (e & 1);
          const int qp = qpos_a + (e >> 1) * 8;
          ok = kpos < sk && (!causal || kpos <= qp) &&
               (window < 0 || kpos > qp - window);
        }
        s[i] = ok ? s[i] * c2 : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int e = i & 3;
        bool ok = true;
        if (edge) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (e & 1);
          const int qp = qpos_a + (e >> 1) * 8;
          ok = kpos < sk && (!causal || kpos <= qp) &&
               (window < 0 || kpos > qp - window);
        }
        s[i] = ok ? exp2f(s[i] - m[e >> 1]) : 0.f;
        sum[e >> 1] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(FULL, sum[h], 1);
        sum[h] += __shfl_xor_sync(FULL, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }

      // P as A fragments from registers, hi and lo halves (see the top):
      // the accumulators of column blocks 2 kk and 2 kk + 1 are the A
      // fragment of k-step kk
      uint32_t hi[KSTEPS][4], lo[KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
          split_bf16(s[i], s[i + 1], hi[kk][r], lo[kk][r]);
        }
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];

      // O += P V: B the tile's V rows, MN-major (trans-b); k-step kk is
      // keys 16 kk.., 2048 bytes on; column blocks BK * 128 bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t bd = smem_desc(vs + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<D>(o, hi[kk], bd);
        wgmma_rs<D>(o, lo[kk], bd);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncthreads();  // this stage is read; the next prefetch may refill it
  }
  cp_async_wait<0>();

  const float den[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    if (r >= sq) continue;
    bf16* orow = out + ((long long)bh * sq + r) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] / den[h], o[4 * j + 2 * h + 1] / den[h]);
  }
}

template <int D>
cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v,
                         bf16* out, long long b, long long hq, long long hkv,
                         long long sq, long long sk, float scale, int causal,
                         int window, cudaStream_t stream) {
  constexpr int BK = D > 128 ? 64 : 128;
  constexpr size_t smem = (size_t)(MQ + 4 * BK) * D * 2 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * hq),
                  static_cast<unsigned>((sq + MQ - 1) / MQ));
  fa_wgmma<D><<<grid, MTHREADS, smem, stream>>>(
      q, k, v, out, (int)hq, (int)hkv, (int)sq, (int)sk, scale, causal,
      window);
  return cudaGetLastError();
}

// One launcher per head dim: the CUDA-core kernel for f32, the
// tensor-core kernel for bf16.
template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* out, long long b,
                     long long hq, long long hkv, long long sq, long long sk,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (D >= 64)  // the wrapper pads a smaller bf16 head_dim
      return launch_wgmma<D>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal,
                             window, stream);
    else
      return cudaErrorInvalidValue;
  }
  else
    return launch_simt<D>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal,
                          window, stream);
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
