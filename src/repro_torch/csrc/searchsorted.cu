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
// writes its id once (8 bytes a float32 key, 6 a bf16 one), and its
// ceil(log2 t) probes hit a few boundaries.  One launch a call, no
// memset: a persistent grid (the SMs times the 1024-thread blocks that
// fit).  Up to t = 1,024 each block lays the search's tree out in
// shared memory once: node k (heap order) holds
// the bound the reference's fixed-step search probes after the turns
// k's bits spell, found by replaying its index arithmetic from t alone,
// or a value no key is >= where the search has closed (lo == hi: its
// remaining steps go left whatever the key); each leaf holds the answer.
// So a step is one probe and one shift (the first five levels sit in
// distinct banks), the reference's answer on any boundaries, NaN and
// duplicates included.  Past 1,024 buckets each step is the reference's,
// probing the boundaries in device memory (mid is clamped to nb - 1, so
// the sentinel pad of the reference's _pad_bounds is never read).
// Then the blocks walk the keys in rounds: each
// thread loads 8 keys (two 16-byte loads of float32 or int32, one of
// bf16), runs the 8 searches interleaved and stores the ids as 16-byte
// vectors.  (Keys loaded a round or two ahead, in registers or in a
// cp.async ring in shared memory, ran slower on the H100.)  A view whose
// data_ptr is not 16-byte aligned (keys[1:]) and a tail that fills no
// vector go through a scalar head and tail in the same launch, and ids
// whose alignment differs from the keys' are stored one by one.
// Counts: per-warp histograms in shared memory while 32 warps x t
// counters fit
// (t <= kWarpHistMax), one block histogram up to SHARED_HIST_MAX; a
// block adds its nonzero counts into the grid's counts with one atomic
// a bucket (up to kWarpHistMax each bucket on a 128-byte line of its
// own).  Past SHARED_HIST_MAX each key adds itself into the grid's
// counts.  Then each block takes a ticket; the last block moves the
// grid's counts into `counts` with atomicExch, leaving zeros -- the TPU
// sums its (blocks, t) partials after its grid, and integer sums are
// exact in any order.  The ticket and the grid's counts live in a
// workspace the wrapper keeps per device and stream, zero when a call
// starts and when it ends, whatever t the calls before it had.  So any
// number of boundaries up to kMaxBounds is taken, past the reference's
// 2^16-lane gate too, with a workspace of the counts' size there.
//
// Keys are float32, bf16 (compared as float32, cmp_key) or int32; a
// bf16 row is read as bf16, half the bytes of a float32 one.
#include "network.cuh"

#include <stdint.h>

using namespace repro;

namespace {

// Rows (and boundary lists) of up to 2^30 keys: the search's int
// arithmetic, lo + hi included, stays in range.
constexpr long long kMaxBounds = 1LL << 30;

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
constexpr int kHistThreads = 1024;
constexpr int kHistWarps = kHistThreads / 32;
// t up to which each warp keeps its own counters (48 KiB in all)
constexpr int kWarpHistMax = SHARED_HIST_MAX / kHistWarps;
// steps up to which a block holds the search's tree: t up to 1,024
constexpr int kTreeStepsMax = 10;
// the most dynamic shared memory a call asks for: the counters and the
// deepest tree (int32 keys: 8-byte nodes and 4-byte leaves)
constexpr int kSmemMax = SHARED_HIST_MAX * 4 + (1 << kTreeStepsMax) * 12;
// keys a thread searches a round: two 16-byte loads of float32 or
// int32, one of bf16
constexpr int kKeysPerThread = 8;
// the workspace: the ticket, then the grid's counts; up to kWarpHistMax
// buckets one 128-byte line a bucket (so that the blocks' atomics on
// different buckets do not queue on one line), past it one int each
constexpr int kWorkspaceHead = 32;
constexpr int kAccStride = 32;

__host__ __device__ constexpr int acc_stride(long long t) {
  return t <= kWarpHistMax ? kAccStride : 1;
}

// Where a block counts: each warp its own counters, one block
// histogram, or the grid's counts in device memory.
enum HistMode { kWarpHist, kBlockHist, kGlobalHist };
// How a block holds the boundaries: the search's tree, or not at all
// (the probes read device memory).
enum SearchMode { kTreeSearch, kDeviceSearch };

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// What a tree node holds: the compared value of the bound the search
// probes there, or, where the search has closed (lo == hi: the
// reference's remaining steps go left whatever the key), a value no
// key is >= -- a NaN for float32 and bf16 keys; int32 keys compare as
// 64-bit integers, below INT64_MAX.
template <typename K>
struct TreeKey {
  using type = K;
  __device__ static K closed() { return __int_as_float(0x7fffffff); }
};
template <>
struct TreeKey<int> {
  using type = long long;
  __device__ static long long closed() { return 0x7fffffffffffffffLL; }
};

// Key i of a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ T vec_key(const uint4& r, int i);
template <>
__device__ __forceinline__ float vec_key<float>(const uint4& r, int i) {
  return __uint_as_float(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
}
template <>
__device__ __forceinline__ int vec_key<int>(const uint4& r, int i) {
  return static_cast<int>(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
}
template <>
__device__ __forceinline__ __nv_bfloat16 vec_key<__nv_bfloat16>(
    const uint4& r, int i) {
  const unsigned w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
  return __ushort_as_bfloat16(
      static_cast<unsigned short>((i & 1) ? w >> 16 : w & 0xffffu));
}

// The boundaries as one block holds them (shared memory, or the caller's
// row in device memory).
template <typename T>
struct Bounds {
  using K = cmp_t<T>;
  using TK = typename TreeKey<K>::type;
  const TK* tree;     // kTreeSearch: node k of the search at tree[k]
  const int* leaf;    // kTreeSearch: the answer at leaf k, leaf[k - 2^steps]
  const T* device;    // kDeviceSearch: the caller's boundaries
};

// kN right searches of the nb boundaries interleaved, each the
// reference's: steps halvings with the lo < hi guard, mid clamped to
// nb - 1.  Through the tree a step is one probe and one shift: node k's
// children are 2k (left) and 2k + 1, and a closed node sends every key
// left, as the reference's guard does.
template <int kN, int kSearch, typename T>
__device__ __forceinline__ void find_buckets(const cmp_t<T>* key, int* id,
                                             int nb, int steps,
                                             const Bounds<T>& b) {
  using TK = typename Bounds<T>::TK;
  if constexpr (kSearch == kTreeSearch) {
    int k[kN];
#pragma unroll
    for (int u = 0; u < kN; ++u) k[u] = 1;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < kN; ++u)
        k[u] = 2 * k[u] + (b.tree[k[u]] <= static_cast<TK>(key[u]));
    }
#pragma unroll
    for (int u = 0; u < kN; ++u) id[u] = b.leaf[k[u] - (1 << steps)];
  } else {
    int hi[kN];
#pragma unroll
    for (int u = 0; u < kN; ++u) id[u] = 0, hi[u] = nb;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int mid = min((id[u] + hi[u]) >> 1, nb - 1);
        const cmp_t<T> bound = cmp_key(b.device[mid]);
        const bool go_right = bound <= key[u] && id[u] < hi[u];
        id[u] = go_right ? mid + 1 : id[u];
        hi[u] = go_right ? hi[u] : mid;
        hi[u] = max(hi[u], id[u]);
      }
    }
  }
}

// Shared-memory bytes of a search mode's boundaries.
template <typename T>
__host__ __device__ long long search_bytes(int search, int steps) {
  using TK = typename TreeKey<cmp_t<T>>::type;
  return search == kTreeSearch
             ? align16((1LL << steps) * (long long)(sizeof(TK) + sizeof(int)))
             : 0;
}

// Shared-memory bytes of a histogram mode's counters.
__host__ __device__ inline long long hist_bytes(int mode, long long t) {
  return align16(mode == kWarpHist ? 4LL * kHistWarps * t
                 : mode == kBlockHist ? 4LL * t : 0);
}

// Block b's share of the grid: the keys at [head, head + nvec * V) as
// 16-byte vectors of V keys, kKeysPerThread keys a thread a round, and
// the < V keys before and after them one by one; ids per the
// reference's right search of the nb boundaries, counted into the
// block's counters, which go into the grid's (or into the grid's
// directly); the last block to finish writes those to counts.
template <typename T, int kMode, int kSearch>
__global__ void __launch_bounds__(kHistThreads, 1)
    bucketize(const T* __restrict__ keys, const T* __restrict__ bounds,
              int* __restrict__ ids, int* __restrict__ counts,
              int* __restrict__ workspace, long long n, int nb, int t,
              int steps, long long head, long long nvec, bool ids_vec) {
  using K = cmp_t<T>;
  using TK = typename TreeKey<K>::type;
  constexpr int V = 16 / sizeof(T);
  constexpr int U = kKeysPerThread / V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int leaves = 1 << steps;
  TK* tree = reinterpret_cast<TK*>(smem);
  int* leaf = reinterpret_cast<int*>(smem + leaves * sizeof(TK));
  int* hist = reinterpret_cast<int*>(smem + search_bytes<T>(kSearch, steps));
  unsigned* ticket = reinterpret_cast<unsigned*>(workspace);
  int* acc = workspace + kWorkspaceHead;
  const int stride = acc_stride(t);
  if constexpr (kSearch == kTreeSearch) {
    // node k (1 <= k < 2^steps) and leaf k (2^steps <= k < 2^(steps+1)):
    // the reference's index arithmetic replayed along k's bits below its
    // top one (1 = went right)
    for (int k = threadIdx.x + 1; k < 2 * leaves; k += kHistThreads) {
      int lo = 0, hi = nb;
      for (int bit = 30 - __clz(k); bit >= 0; --bit) {
        const int mid = min((lo + hi) >> 1, nb - 1);
        const bool go_right = ((k >> bit) & 1) && lo < hi;
        lo = go_right ? mid + 1 : lo;
        hi = go_right ? hi : mid;
        hi = max(hi, lo);
      }
      if (k >= leaves)
        leaf[k - leaves] = lo;
      else
        tree[k] = lo < hi ? static_cast<TK>(
                                cmp_key(bounds[min((lo + hi) >> 1, nb - 1)]))
                          : TreeKey<K>::closed();
    }
  }
  if constexpr (kMode != kGlobalHist) {
    const int cells = kMode == kWarpHist ? kHistWarps * t : t;
    for (int i = threadIdx.x; i < cells; i += kHistThreads) hist[i] = 0;
  }
  __syncthreads();
  const Bounds<T> bnd{tree, leaf, bounds};
  // past SHARED_HIST_MAX the stride is 1: a key counts into the grid's
  int* mine = kMode == kWarpHist ? hist + (threadIdx.x >> 5) * t
              : kMode == kBlockHist ? hist : acc;
  const long long gtid = blockIdx.x * (long long)kHistThreads + threadIdx.x;
  const long long tail0 = head + nvec * V;
  // the scalar head and tail, one key each to the grid's first threads
  for (int part = 0; part < 2; ++part) {
    const long long g = part == 0 ? (gtid < head ? gtid : -1)
                                  : (gtid < n - tail0 ? tail0 + gtid : -1);
    if (g < 0) continue;
    const K key = cmp_key(keys[g]);
    int id;
    find_buckets<1, kSearch>(&key, &id, nb, steps, bnd);
    ids[g] = id;
    atomicAdd(&mine[id], 1);
  }
  const uint4* vk = reinterpret_cast<const uint4*>(keys + head);
  const long long round = (long long)gridDim.x * kHistThreads * U;
  for (long long v0 = blockIdx.x * (long long)kHistThreads * U; v0 < nvec;
       v0 += round) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = v0 + u * kHistThreads + threadIdx.x;
      raw[u] = v < nvec ? __ldcs(vk + v) : make_uint4(0, 0, 0, 0);
    }
    K key[kKeysPerThread];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i)
        key[u * V + i] = cmp_key(vec_key<T>(raw[u], i));
    int id[kKeysPerThread];
    find_buckets<kKeysPerThread, kSearch>(key, id, nb, steps, bnd);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = v0 + u * kHistThreads + threadIdx.x;
      if (v >= nvec) continue;
      int* out = ids + head + v * V;
      if (ids_vec) {
#pragma unroll
        for (int i = 0; i < V; i += 4)
          __stcs(reinterpret_cast<int4*>(out + i),
                 make_int4(id[u * V + i], id[u * V + i + 1],
                           id[u * V + i + 2], id[u * V + i + 3]));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = id[u * V + i];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) atomicAdd(&mine[id[u * V + i]], 1);
    }
  }
  __syncthreads();
  // the block's counts into the grid's, one atomic a nonzero bucket
  if constexpr (kMode != kGlobalHist) {
    for (int j = threadIdx.x; j < t; j += kHistThreads) {
      int sum = 0;
      if constexpr (kMode == kWarpHist) {
        for (int w = 0; w < kHistWarps; ++w) sum += hist[w * t + j];
      } else {
        sum = hist[j];
      }
      if (sum != 0) atomicAdd(&acc[(long long)j * stride], sum);
    }
  }
  // the block's counts land before its ticket; the last block takes the
  // grid's counts out and leaves zeros for the next call
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < t; j += kHistThreads)
    counts[j] = atomicExch(&acc[(long long)j * stride], 0);
  if (threadIdx.x == 0) *ticket = 0u;
}

int sm_count(int dev) {
  static int sms[64] = {0};
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

// The blocks of one instance resident at once on the current card, at
// `smem` bytes of dynamic shared memory: asked once per card and size.
template <typename T, int kMode, int kSearch>
int resident_blocks(size_t smem, int dev) {
  static int answer[64] = {0};
  static size_t asked[64] = {0};
  static bool raised = false;
  auto kernel = bucketize<T, kMode, kSearch>;
  if (!raised) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemMax);
    raised = true;
  }
  if (dev < 0 || dev >= 64) dev = 0;
  if (answer[dev] == 0 || asked[dev] != smem) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kHistThreads, smem) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    answer[dev] = per_sm * sm_count(dev);
    asked[dev] = smem;
  }
  return answer[dev];
}

template <typename T, int kMode, int kSearch>
int launch_bucketize(const T* keys, const T* bounds, int* ids, int* counts,
                     int* workspace, long long n, long long t, int steps,
                     cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long nb = t - 1;
  const long long mis = reinterpret_cast<uintptr_t>(keys) % 16;
  long long head = mis == 0 ? 0 : (16 - mis) / (long long)sizeof(T);
  head = head < n ? head : n;
  const long long nvec = (n - head) / V;
  const bool ids_vec = reinterpret_cast<uintptr_t>(ids + head) % 16 == 0;
  const size_t smem = search_bytes<T>(kSearch, steps) + hist_bytes(kMode, t);
  int dev = 0;
  cudaGetDevice(&dev);
  long long blocks = resident_blocks<T, kMode, kSearch>(smem, dev);
  const long long per_block = (long long)kHistThreads * kKeysPerThread / V;
  const long long need = (nvec + per_block - 1) / per_block;
  blocks = blocks < need ? blocks : need;
  blocks = blocks > 1 ? blocks : 1;
  bucketize<T, kMode, kSearch><<<blocks, kHistThreads, smem, stream>>>(
      keys, bounds, ids, counts, workspace, n, (int)nb, (int)t, steps, head,
      nvec, ids_vec);
  return static_cast<int>(cudaGetLastError());
}

// t <= kWarpHistMax: each warp's counters and the tree (steps <= 9);
// t <= SHARED_HIST_MAX: a block histogram and the tree (t <= 1,024) or
// no copy; past it the grid's counters in device memory and no copy.
template <typename T>
int bucketize_keys(const T* keys, const T* bounds, int* ids, int* counts,
                   int* workspace, long long n, long long t,
                   cudaStream_t stream) {
  if (t < 2 || t - 1 > kMaxBounds || n < 0 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = t - 1;
  int steps = 0;                // ceil(log2(nb + 1)): nb's bit length
  while ((nb >> steps) > 0) ++steps;
  if (t <= kWarpHistMax)
    return launch_bucketize<T, kWarpHist, kTreeSearch>(
        keys, bounds, ids, counts, workspace, n, t, steps, stream);
  if (t <= SHARED_HIST_MAX)
    return steps <= kTreeStepsMax
               ? launch_bucketize<T, kBlockHist, kTreeSearch>(
                     keys, bounds, ids, counts, workspace, n, t, steps, stream)
               : launch_bucketize<T, kBlockHist, kDeviceSearch>(
                     keys, bounds, ids, counts, workspace, n, t, steps,
                     stream);
  return launch_bucketize<T, kGlobalHist, kDeviceSearch>(
      keys, bounds, ids, counts, workspace, n, t, steps, stream);
}

// The workspace a call with t buckets needs, in ints: the ticket's head
// and the grid's counts.  It never shrinks as t grows (the lines of
// kWarpHistMax buckets at least), so one made for some t serves every
// smaller one.
long long workspace_ints(long long t) {
  const long long lines = (long long)kAccStride * kWarpHistMax;
  return kWorkspaceHead + (t > lines ? t : lines);
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
// counts (t,) int32, all written here; workspace: at least
// bucketize_histogram_workspace(t) ints, its first word 0 on entry (and
// on return).
#define BUCKETIZE_ENTRY(SUFFIX, T)                                           \
  extern "C" int bucketize_histogram_##SUFFIX(                              \
      const T* keys, const T* bounds, int* ids, int* counts, int* workspace, \
      long long n, long long t, void* stream) {                             \
    return bucketize_keys(keys, bounds, ids, counts, workspace, n, t,       \
                          static_cast<cudaStream_t>(stream));               \
  }

BUCKETIZE_ENTRY(f32, float)
BUCKETIZE_ENTRY(i32, int)
BUCKETIZE_ENTRY(bf16, __nv_bfloat16)

extern "C" long long bucketize_histogram_workspace(long long t) {
  return workspace_ints(t);
}
