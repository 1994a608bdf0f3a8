// Shared pieces of the port's comparison kernels (sort, search, merge).
//
// Comparison semantics.  The JAX reference runs on XLA, which compares
// floats with denormals flushed to zero: every denormal of either sign
// equals +-0.0, and -0.0 equals +0.0.  The card does not flush unless
// told to (and these sources are built without -ftz and without
// --use_fast_math), so every comparison here goes through cmp_key(),
// which folds a denormal to the zero of its sign in the bits domain.
// bf16 keys are widened to float32 by cmp_key (exact, order-keeping;
// bf16 has float32's exponent field, so its denormals are the ones XLA
// flushes when it widens them): the kernels compare cmp_t<T> values and
// move T values.  The data itself is only ever moved, never rewritten:
// a sort or merge returns a permutation of its input.
//
// Swap rule.  A compare-exchange swaps only when gt(a, b) differs from
// the direction bit, as the reference's _compare_exchange does
// (src/repro/kernels/bitonic.py:70-86).  An unordered pair (a NaN) is
// never swapped, so no value is lost or duplicated.  fminf/fmaxf would
// break both properties.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace repro {

__device__ __forceinline__ float cmp_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x7f800000u) == 0u ? __uint_as_float(u & 0x80000000u) : v;
}

__device__ __forceinline__ float cmp_key(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
  return (u & 0x7f800000u) == 0u ? __uint_as_float(u & 0x80000000u)
                                 : __uint_as_float(u);
}

__device__ __forceinline__ int cmp_key(int v) { return v; }

// The type a key of T compares as: float for float32 and bf16, int for
// int32.
template <typename T>
using cmp_t = decltype(cmp_key(std::declval<T>()));

template <typename T>
__device__ __forceinline__ bool gt(T a, T b) {
  return cmp_key(a) > cmp_key(b);
}

template <typename T>
__device__ __forceinline__ bool eq(T a, T b) {
  return cmp_key(a) == cmp_key(b);
}

// Lexicographic (key, value) order: pair a sorts after pair b, as the
// reference's _compare_exchange_kv decides it (bitonic.py:89-102).
template <typename T>
__device__ __forceinline__ bool gt_kv(T ka, int va, T kb, int vb) {
  return gt(ka, kb) || (eq(ka, kb) && va > vb);
}

// Compare-exchange of x[i] and x[i + d]; desc flips the direction.
template <typename T>
__device__ __forceinline__ void compare_exchange(T* x, long long i,
                                                 long long d, bool desc) {
  const T a = x[i];
  const T b = x[i + d];
  if (gt(a, b) != desc) {
    x[i] = b;
    x[i + d] = a;
  }
}

// The same on (key, value) pairs: both channels move together.
template <typename T>
__device__ __forceinline__ void compare_exchange_kv(T* k, int* v, long long i,
                                                    long long d, bool desc) {
  const T ka = k[i], kb = k[i + d];
  const int va = v[i], vb = v[i + d];
  if (gt_kv(ka, va, kb, vb) != desc) {
    k[i] = kb;
    k[i + d] = ka;
    v[i] = vb;
    v[i + d] = va;
  }
}

// One compare-exchange on keys alone (KV false; v is unused) or on
// (key, value) pairs.
template <typename T, bool KV>
__device__ __forceinline__ void compare_exchange_any(T* k, int* v,
                                                     long long i, long long d,
                                                     bool desc) {
  if constexpr (KV)
    compare_exchange_kv(k, v, i, d, desc);
  else
    compare_exchange(k, i, d, desc);
}

// The value that sorts last: +inf for floats (bf16 0x7f80), int32 max;
// what the reference pads a row with (sort_sentinel).
template <typename T> __device__ __forceinline__ T sentinel();
template <> __device__ __forceinline__ float sentinel<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ int sentinel<int>() {
  return 0x7fffffff;
}
template <>
__device__ __forceinline__ __nv_bfloat16 sentinel<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0x7f80);
}

// Lower index of pair q of a substage at distance d (within a row or
// an aligned block): pairs (p, p + d) with bit log2(d) of p clear.
__device__ __forceinline__ long long pair_low(long long q, long long d) {
  return (q / d) * (2 * d) + (q % d);
}

// One substage at distance d >= tile over global memory, one thread per
// pair.  Rows of length n (a power of two) lie back to back.  With
// sort_dirs the direction of stage k is bit k+1 of the position in the
// row, as in the reference's _directions(); without it every pair is
// ascending (the merge cascades).  With KV the int32 value channel v,
// laid out as x, moves with the keys.
template <typename T, bool KV>
__global__ void global_substage(T* x, int* v, long long total_pairs,
                                long long n, long long d, int k,
                                bool sort_dirs) {
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= total_pairs) return;
  const long long half = n / 2;
  const long long row = q / half;
  const long long p = pair_low(q % half, d);
  const bool desc = sort_dirs && (((p >> (k + 1)) & 1) != 0);
  compare_exchange_any<T, KV>(x + row * n, KV ? v + row * n : v, p, d, desc);
}

inline int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

}  // namespace repro

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
