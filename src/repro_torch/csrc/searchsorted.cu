// Batched searchsorted: for each of nq queries of each of batch rows,
// the number of elements of that row's sorted (n,) array that are
// < the query (left) or <= it (right), as int32, optionally clamped to
// valid_len.  And the fused bucketize + histogram: each key's bucket id
// (a right search into the t - 1 boundaries) and the count of keys in
// each of the t buckets.
//
// Replaces: src/repro/kernels/bucketize.py searchsorted (:128,
// pallas_call at :145) with the clamp of src/repro/kernels/ops.py
// searchsorted's valid_len (:489-490), and bucketize_histogram
// (pallas_call at :109, body _bucketize_kernel :62); both run the
// reference's search _bin_search_block (:34-59) step for step: a fixed
// count of branch-free halvings with the lo < hi guard and the clamp of
// mid to n-1, so duplicate bounds, sentinel tails, NaN queries (bucket
// 0) and NaN inside a row give the reference's answer.
//
// What bounds searchsorted on the H100.  The TPU holds the whole sorted
// row in VMEM and streams query blocks past it.  A 65,536-key row does
// not fit shared memory, and SMMS's Round 3 asks only t - 1 = 63
// queries of each, so the bytes are nothing and the time is the chain of
// ~17 dependent probes a query makes.  The first L steps of the
// fixed-step search visit the same positions whatever the query: at
// most 2^L - 1 of them, a binary tree computed from n alone.  One block
// takes one row's chunk of queries; its threads load that tree's keys
// into shared memory in one parallel round (node k's position is found
// by replaying the search's index arithmetic along k's bits), then each
// query runs steps 0..L-1 against shared memory and the rest against
// the row in global memory, with the same positions, comparisons and
// order as the reference, so the answer is bitwise its own on any row.
// L grows with the queries a block shares the tree with (7 for 63
// queries: 127 keys, 512 bytes), so 17 dependent global rounds become
// one parallel round and 10 dependent ones.  Queries come with a row
// stride: nq for (batch, nq) queries, 0 when one query row serves every
// row, so a shared row is never copied.  All rows go in one launch, and
// at the paths' shapes the host's issue time (an output allocation and
// one ctypes call) is longer than the kernel's few microseconds.
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

// Queries a search block takes.
constexpr int kSearchThreads = 256;
// Tree keys a thread stages: the tree holds fewer than kTreePerQuery
// keys for each query of the block (at most 255 keys, 1 KiB).  Deeper
// trees cost more to stage than the steps they save: the rows a search
// reads were just written and sit in L2.
constexpr int kTreePerQuery = 2;

// One step of the reference's search at mid with key b: the lo < hi
// guard, then hi = max(hi, lo).  Returns whether it went right.
template <typename K>
__device__ __forceinline__ bool search_step(int& lo, int& hi, int mid, K b,
                                            K key, int right) {
  const bool pred = right ? (b <= key) : (b < key);
  const bool go_right = pred && (lo < hi);
  lo = go_right ? mid + 1 : lo;
  hi = go_right ? hi : mid;
  hi = max(hi, lo);
  return go_right;
}

// Block (row, chunk): queries [chunk * blockDim.x, ...) of that row.
// Node k (1 <= k < 2^levels, heap order) of the tree holds the key the
// search reads at its step depth(k) after the decisions k's bits below
// its top bit spell (1 = went right); a node no query reaches gets the
// key at whatever position the arithmetic gives, never read.
template <typename T>
__global__ void __launch_bounds__(kSearchThreads)
    search(const T* __restrict__ arr, const T* __restrict__ queries,
           int* __restrict__ out, long long n, long long nq,
           long long q_stride, long long chunks, int right, int steps,
           int levels, long long valid_len) {
  using K = cmp_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* tree = reinterpret_cast<K*>(smem_raw);          // tree[k - 1]: node k
  const long long row = blockIdx.x / chunks;
  const long long j = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  const T* bounds = arr + row * n;
  const int nb = static_cast<int>(n);
  // a thread's nodes: positions first, then every load in flight at once
  T node[kTreePerQuery];
#pragma unroll
  for (int u = 0; u < kTreePerQuery; ++u) {
    const int k = threadIdx.x + 1 + u * blockDim.x;
    int lo = 0, hi = nb;
    for (int bit = 30 - __clz(k); bit >= 0; --bit) {
      const int mid = min((lo + hi) / 2, nb - 1);
      const bool go_right = (k >> bit) & 1;
      lo = go_right ? mid + 1 : lo;
      hi = go_right ? hi : mid;
      hi = max(hi, lo);
    }
    if (k < (1 << levels)) node[u] = bounds[min((lo + hi) / 2, nb - 1)];
  }
#pragma unroll
  for (int u = 0; u < kTreePerQuery; ++u) {
    const int k = threadIdx.x + 1 + u * blockDim.x;
    if (k < (1 << levels)) tree[k - 1] = cmp_key(node[u]);
  }
  __syncthreads();
  if (j >= nq) return;
  const K key = cmp_key(queries[row * q_stride + j]);
  int lo = 0, hi = nb, k = 1;
  for (int s = 0; s < levels; ++s) {
    const int mid = min((lo + hi) / 2, nb - 1);
    k = 2 * k + search_step(lo, hi, mid, tree[k - 1], key, right);
  }
  for (int s = levels; s < steps; ++s) {
    const int mid = min((lo + hi) / 2, nb - 1);
    search_step(lo, hi, mid, cmp_key(bounds[mid]), key, right);
  }
  out[row * nq + j] = valid_len >= 0 && lo > valid_len
                          ? static_cast<int>(valid_len) : lo;
}

template <typename T>
int search_rows(const T* arr, const T* queries, int* out, long long batch,
                long long n, long long nq, long long q_stride, int right,
                long long valid_len, cudaStream_t stream) {
  if (batch <= 0 || nq <= 0 || n <= 0)
    return static_cast<int>(cudaGetLastError());
  if (n > kMaxBounds) return static_cast<int>(cudaErrorInvalidValue);
  // the reference's step count, ceil(log2(n + 1)): n's bit length
  int steps = 0;
  while ((n >> steps) > 0) ++steps;
  // a power-of-two warp multiple of threads up to kSearchThreads; a tree
  // of about kTreePerQuery keys a query, no deeper than the search
  int threads = 32;
  while (threads < nq && threads < kSearchThreads) threads *= 2;
  int levels = 1;
  while ((2 << levels) <= threads * kTreePerQuery) ++levels;
  levels = levels < steps ? levels : steps;
  const long long chunks = (nq + threads - 1) / threads;
  const size_t smem = ((1 << levels) - 1) * sizeof(cmp_t<T>);
  search<T><<<batch * chunks, threads, smem, stream>>>(
      arr, queries, out, n, nq, q_stride, chunks, right, steps, levels,
      valid_len);
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

// arr (batch, n) sorted rows; queries (batch, nq) with row stride
// q_stride (0: one row for all); out (batch, nq) int32; valid_len < 0
// means no clamp.
#define SEARCH_ENTRY(SUFFIX, T)                                              \
  extern "C" int searchsorted_##SUFFIX(                                     \
      const T* arr, const T* queries, int* out, long long batch,            \
      long long n, long long nq, long long q_stride, int right,             \
      long long valid_len, void* stream) {                                  \
    return search_rows(arr, queries, out, batch, n, nq, q_stride, right,    \
                       valid_len, static_cast<cudaStream_t>(stream));       \
  }

SEARCH_ENTRY(f32, float)
SEARCH_ENTRY(i32, int)
SEARCH_ENTRY(bf16, __nv_bfloat16)

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

extern "C" int bucketize_histogram_bf16(const __nv_bfloat16* keys,
                                        const __nv_bfloat16* bounds, int* ids,
                                        int* counts, long long n, long long t,
                                        int steps, void* stream) {
  return bucketize_keys(keys, bounds, ids, counts, n, t, steps,
                        static_cast<cudaStream_t>(stream));
}
