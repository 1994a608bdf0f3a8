// Batched searchsorted: for each of nq queries of each of batch rows,
// the number of elements of that row's sorted (n,) array that are
// < the query (left) or <= it (right), as int32.  And the fused
// bucketize + histogram: each key's bucket id (a right search into the
// t - 1 boundaries) and the count of keys in each of the t buckets.
//
// Replaces: src/repro/kernels/bucketize.py searchsorted (:128,
// pallas_call at :145) and bucketize_histogram (pallas_call at :109,
// body _bucketize_kernel :62); both run the reference's search
// _bin_search_block (:34-59) step for step: a fixed count of
// branch-free halvings with the lo < hi guard and the clamp of mid to
// n-1, so duplicate bounds and sentinel tails give the same answer.
//
// What bounds searchsorted on the H100.  The TPU holds the whole sorted
// row in VMEM and streams query blocks past it.  Here a 65,536-key row
// (256 KiB) does not fit shared memory and there are only t-1 = 63
// queries per row, so staging the row would cost far more than the
// search: one thread per query reads its ~17 probes straight from
// global memory (the first probes of a row's queries coincide, and the
// rest hit L2).  All rows go in one launch.  At (64 rows x 63 queries)
// the work is tiny; launch latency and the dependent probe chain bound
// it, far above the bytes-moved bound.
//
// bucketize_histogram is bounded by bytes: it reads each key once and
// writes its id once (8 bytes a key), and its ceil(log2 t) probes hit
// the few boundaries in L1.  Each thread searches keys in a grid-stride
// loop and adds one to its bucket's counter in a shared-memory
// histogram of t int32 counters; at the end each block adds its
// nonzero counters to the global counts with atomicAdd.  The TPU grid
// writes one (blocks, t) partial histogram and sums it afterwards; here
// blocks run in no order, and integer atomics are exact, so the counts
// are the same whatever order they land in.  Past SHARED_HIST_MAX
// buckets the counters would not fit shared memory, and each key adds
// to the global counts directly (equally exact): so any number of
// boundaries up to kMaxBounds is taken, past the reference's 2^16-lane
// gate too.
//
// Keys are float32, bf16 (compared as float32, cmp_key) or int32; a
// bf16 row is read as bf16, half the bytes of a float32 one.
#include "network.cuh"

using namespace repro;

namespace {

// Rows (and boundary lists) of up to 2^30 keys: the search's int
// arithmetic, lo + hi included, stays in range.
constexpr long long kMaxBounds = 1LL << 30;

// The reference's search: #bounds <= key (right) or < key (left) among
// the n sorted bounds, in `steps` = ceil(log2(n + 1)) halvings.
template <typename T>
__device__ __forceinline__ int bin_search(const T* bounds, int n,
                                          cmp_t<T> key, int right,
                                          int steps) {
  int lo = 0, hi = n;
  for (int s = 0; s < steps; ++s) {
    const int mid = min((lo + hi) / 2, n - 1);
    const cmp_t<T> b = cmp_key(bounds[mid]);
    const bool pred = right ? (b <= key) : (b < key);
    const bool go_right = pred && (lo < hi);
    lo = go_right ? mid + 1 : lo;
    hi = go_right ? hi : mid;
    hi = max(hi, lo);
  }
  return lo;
}

template <typename T>
__global__ void search(const T* arr, const T* queries, int* out,
                       long long batch, long long n, long long nq,
                       int right, int steps) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= batch * nq) return;
  out[g] = bin_search(arr + (g / nq) * n, (int)n, cmp_key(queries[g]), right,
                      steps);
}

template <typename T>
int search_rows(const T* arr, const T* queries, int* out, long long batch,
                long long n, long long nq, int right, int steps,
                cudaStream_t stream) {
  const long long total = batch * nq;
  if (total <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > kMaxBounds) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  search<T><<<(total + threads - 1) / threads, threads, 0, stream>>>(
      arr, queries, out, batch, n, nq, right, steps);
  return static_cast<int>(cudaGetLastError());
}

constexpr int SHARED_HIST_MAX = 12288;  // 48 KiB of int32 counters
constexpr int HIST_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(HIST_THREADS)
    bucketize(const T* keys, const T* bounds, int* ids, int* counts,
              long long n, int n_bounds, int t, int steps) {
  extern __shared__ int hist[];
  const bool shared = t <= SHARED_HIST_MAX;
  if (shared) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < n;
       g += stride) {
    const int id = bin_search(bounds, n_bounds, cmp_key(keys[g]), 1, steps);
    ids[g] = id;                       // in [0, n_bounds] = [0, t - 1]
    atomicAdd(shared ? &hist[id] : &counts[id], 1);
  }
  if (shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < t; i += blockDim.x)
      if (hist[i]) atomicAdd(&counts[i], hist[i]);
  }
}

template <typename T>
int bucketize_keys(const T* keys, const T* bounds, int* ids, int* counts,
                   long long n, long long t, int steps,
                   cudaStream_t stream) {
  if (t < 2 || t - 1 > kMaxBounds)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * t, stream);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  // enough blocks to fill the card several times over; each thread
  // walks the keys with a grid stride
  const long long need = (n + HIST_THREADS - 1) / HIST_THREADS;
  const long long blocks = need < 132LL * 8 ? need : 132LL * 8;
  const size_t smem = t <= SHARED_HIST_MAX ? sizeof(int) * t : 0;
  bucketize<T><<<blocks, HIST_THREADS, smem, stream>>>(
      keys, bounds, ids, counts, n, (int)(t - 1), (int)t, steps);
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

// keys (n,), boundaries (t - 1,) ascending, t >= 2 -> ids (n,) int32 and
// counts (t,) int32 (cleared here).
extern "C" int bucketize_histogram_f32(const float* keys, const float* bounds,
                                       int* ids, int* counts, long long n,
                                       long long t, int steps, void* stream) {
  return bucketize_keys(keys, bounds, ids, counts, n, t, steps,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int bucketize_histogram_i32(const int* keys, const int* bounds,
                                       int* ids, int* counts, long long n,
                                       long long t, int steps, void* stream) {
  return bucketize_keys(keys, bounds, ids, counts, n, t, steps,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int searchsorted_bf16(const __nv_bfloat16* arr,
                                 const __nv_bfloat16* queries, int* out,
                                 long long batch, long long n, long long nq,
                                 int right, int steps, void* stream) {
  return search_rows(arr, queries, out, batch, n, nq, right, steps,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int bucketize_histogram_bf16(const __nv_bfloat16* keys,
                                        const __nv_bfloat16* bounds, int* ids,
                                        int* counts, long long n, long long t,
                                        int steps, void* stream) {
  return bucketize_keys(keys, bounds, ids, counts, n, t, steps,
                        static_cast<cudaStream_t>(stream));
}
