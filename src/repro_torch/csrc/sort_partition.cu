// Fused sort and boundary partition of each row of a (rows, m) array,
// padded to a power of two with the sort sentinel: the keys alone
// (sort_partition_*) or (key, int32 value) pairs in lexicographic order
// (sort_partition_kv_*), and for each row's nq queries the count of
// sorted elements among the first m that compare below it -- the left
// searchsorted of the queries over the sorted row.
//
// Replaces: src/repro/kernels/fused.py sort_partition (pallas_call at :87;
// body _sort_partition_kernel :49) and sort_partition_kv (pallas_call at
// :118; body _sort_partition_kv_kernel :56).  The TPU kernels sort one
// row in VMEM with the bitonic network and then binary-search the
// queries over it with bucketize._bin_search_block(q, xs, m, "left").
// Here the network is the one of csrc/bitonic_sort.cu (same pairs, same
// directions, same swap rule, so the sorted row is bitwise the plain
// version's).
//
// Both run one launch a call (sort_tiles.cuh row_sort): the row in a
// CTA's shared memory, or in a cluster's for rows of 2^14-2^16 padded
// slots, as in csrc/bitonic_sort.cu; the pair sort generates its order
// channel as the row loads (the column, int32 max on a pad: the
// reference's iota padded, fused.py:111-112, so the order is the stable
// argsort).  After the network each query runs the reference's
// fixed-step search over the row's first m sorted keys, each probe read
// from the CTA that holds it, and writes its cut: no memset, no atomics,
// and the reference's cuts for any row, NaN keys included (the network
// leaves a NaN where its swap rule puts it, so a row holding one is not
// sorted, and only the reference's own probes give its cut).  Rows past
// 2^16 padded slots (direct calls only) are sorted in a scratch by the
// split schedule and searched there the same way.
//
// What bounds it on the H100: the sort, as for bitonic_sort.cu.  The
// search adds nq probes chains of ceil(log2(m+1)) steps a row (Terasort's
// Round 3: 63 queries of 17 steps), against the reference's separate
// search pass over the sorted row.  Keys are float32, int32 or bf16
// (compared as float32, network.cuh cmp_key).
#include "sort_tiles.cuh"

using namespace repro;

// keys: (rows, m) in; queries: (rows, nq) in; keys_out: (rows, m) out;
// cuts: (rows, nq) out; scratch: (rows, pow2 >= m), read only past 2^16
// padded slots.
#define SORT_PARTITION_ENTRY(SUFFIX, T)                                     \
  extern "C" int sort_partition_##SUFFIX(                                   \
      const T* keys, const T* queries, T* keys_out, int* cuts, T* scratch,  \
      long long rows, long long m, long long nq, void* stream) {            \
    return sort_unpadded<T, false, true>(                                   \
        keys, nullptr, keys_out, nullptr, scratch, nullptr, rows, m,        \
        queries, cuts, nq, static_cast<cudaStream_t>(stream));              \
  }

SORT_PARTITION_ENTRY(f32, float)
SORT_PARTITION_ENTRY(i32, int)
SORT_PARTITION_ENTRY(bf16, __nv_bfloat16)

// keys: (rows, m) in; queries: (rows, nq) in; keys_out, order_out (the
// stable argsort): (rows, m) out; cuts: (rows, nq) out; scratch,
// scratch_values: (rows, pow2 >= m), read only past 2^16 padded slots.
#define SORT_PARTITION_KV_ENTRY(SUFFIX, T)                                  \
  extern "C" int sort_partition_kv_##SUFFIX(                                \
      const T* keys, const T* queries, T* keys_out, int* order_out,         \
      int* cuts, T* scratch, int* scratch_values, long long rows,           \
      long long m, long long nq, void* stream) {                            \
    return sort_unpadded<T, true, true>(                                    \
        keys, nullptr, keys_out, order_out, scratch, scratch_values, rows,  \
        m, queries, cuts, nq, static_cast<cudaStream_t>(stream));           \
  }

SORT_PARTITION_KV_ENTRY(f32, float)
SORT_PARTITION_KV_ENTRY(i32, int)
SORT_PARTITION_KV_ENTRY(bf16, __nv_bfloat16)
