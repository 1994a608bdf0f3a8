// Batched searchsorted: for each of nq queries of each of batch rows,
// the number of elements of that row's sorted (n,) array that are
// < the query (left) or <= it (right), as int32.
//
// Replaces: src/repro/kernels/bucketize.py searchsorted (:128,
// pallas_call at :145, body _bin_search_block :34-59) -- the Round-3
// cut of SMMS (t-1 boundaries into each machine's sorted row).  The
// search is the reference's, step for step: a fixed count of
// branch-free halvings with the lo < hi guard and the clamp of mid to
// n-1, so duplicate bounds and sentinel tails give the same answer.
//
// What bounds it on the H100.  The TPU holds the whole sorted row in
// VMEM and streams query blocks past it.  Here a 65,536-key row
// (256 KiB) does not fit shared memory and there are only t-1 = 63
// queries per row, so staging the row would cost far more than the
// search: one thread per query reads its ~17 probes straight from
// global memory (the first probes of a row's queries coincide, and the
// rest hit L2).  All rows go in one launch.  At (64 rows x 63 queries)
// the work is tiny; launch latency and the dependent probe chain bound
// it, far above the bytes-moved bound.
#include "network.cuh"

using namespace repro;

namespace {

template <typename T>
__global__ void search(const T* arr, const T* queries, int* out,
                       long long batch, long long n, long long nq,
                       int right, int steps) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= batch * nq) return;
  const T* row = arr + (g / nq) * n;
  const T key = cmp_key(queries[g]);
  const int nb = (int)n;
  int lo = 0, hi = nb;
  for (int s = 0; s < steps; ++s) {
    const int mid = min((lo + hi) / 2, nb - 1);
    const T b = cmp_key(row[mid]);
    const bool pred = right ? (b <= key) : (b < key);
    const bool go_right = pred && (lo < hi);
    lo = go_right ? mid + 1 : lo;
    hi = go_right ? hi : mid;
    hi = max(hi, lo);
  }
  out[g] = lo;
}

template <typename T>
int search_rows(const T* arr, const T* queries, int* out, long long batch,
                long long n, long long nq, int right, int steps,
                cudaStream_t stream) {
  const long long total = batch * nq;
  if (total <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 128;
  search<T><<<(total + threads - 1) / threads, threads, 0, stream>>>(
      arr, queries, out, batch, n, nq, right, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int searchsorted_f32(const float* arr, const float* queries,
                                int* out, long long batch, long long n,
                                long long nq, int right, int steps,
                                void* stream) {
  return search_rows(arr, queries, out, batch, n, nq, right, steps,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int searchsorted_i32(const int* arr, const int* queries, int* out,
                                long long batch, long long n, long long nq,
                                int right, int steps, void* stream) {
  return search_rows(arr, queries, out, batch, n, nq, right, steps,
                     static_cast<cudaStream_t>(stream));
}
