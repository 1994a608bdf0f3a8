// Fused sort and boundary partition of each row of a (rows, n) array, n a
// power of two: the keys alone (sort_partition_*) or (key, int32 value)
// pairs in lexicographic order (sort_partition_kv_*), and for each row's
// nq queries the count of sorted elements among the first m that compare
// below it -- the left searchsorted of the queries over the sorted row.
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
// The keys-only sort (sort_partition_*) fuses the search into the split
// schedule's last launch: each 8192-element tile of the sorted row
// counts its own elements below each query and adds the count to the
// row's cut (sort_tiles.cuh tile_stages); for a sorted row the
// reference's guarded binary search returns exactly that count.
//
// The pair sort (sort_partition_kv_*) is one launch a call
// (sort_tiles.cuh row_sort): the row in a CTA's shared memory, or in a
// cluster's for rows of 2^14-2^16 padded pairs, the order channel
// generated as the row loads (the column, int32 max on a pad: the
// reference's iota padded, fused.py:111-112, so the order is the stable
// argsort), and after the network each query runs the reference's
// fixed-step search over the row's first m sorted keys, each probe read
// from the CTA that holds it, and writes its cut: no memset, no atomics,
// and the reference's cuts for any row, NaN keys included.  Rows past
// 2^16 padded pairs (direct calls only) are sorted in a scratch by the
// split schedule and searched there the same way.
//
// What bounds it on the H100: the sort, as for bitonic_sort.cu.  The
// search adds nq probes chains of ceil(log2(m+1)) steps a row (Terasort's
// Round 3: 63 queries of 17 steps), against the reference's separate
// search pass over the sorted row.  Keys are float32, int32 or bf16
// (compared as float32, network.cuh cmp_key).
#include "sort_tiles.cuh"

using namespace repro;

namespace {

template <typename T>
int sort_partition_rows(T* x, const T* queries, int* cuts, long long rows,
                        long long n, long long m, long long nq,
                        void* stream) {
  return sort_rows<T, false>(x, nullptr, rows, n,
                             TileSearch<T>{queries, cuts, m, nq}, true,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int sort_partition_f32(float* x, const float* queries, int* cuts,
                                  long long rows, long long n, long long m,
                                  long long nq, void* stream) {
  return sort_partition_rows<float>(x, queries, cuts, rows, n, m, nq,
                                    stream);
}

extern "C" int sort_partition_i32(int* x, const int* queries, int* cuts,
                                  long long rows, long long n, long long m,
                                  long long nq, void* stream) {
  return sort_partition_rows<int>(x, queries, cuts, rows, n, m, nq, stream);
}

extern "C" int sort_partition_bf16(__nv_bfloat16* x,
                                   const __nv_bfloat16* queries, int* cuts,
                                   long long rows, long long n, long long m,
                                   long long nq, void* stream) {
  return sort_partition_rows<__nv_bfloat16>(x, queries, cuts, rows, n, m,
                                            nq, stream);
}

// keys: (rows, m) in; queries: (rows, nq) in; keys_out, order_out (the
// stable argsort): (rows, m) out; cuts: (rows, nq) out; scratch,
// scratch_values: (rows, pow2 >= m), read only past 2^16 padded slots.
#define SORT_PARTITION_KV_ENTRY(SUFFIX, T)                                  \
  extern "C" int sort_partition_kv_##SUFFIX(                                \
      const T* keys, const T* queries, T* keys_out, int* order_out,         \
      int* cuts, T* scratch, int* scratch_values, long long rows,           \
      long long m, long long nq, void* stream) {                            \
    return sort_pairs<T, true>(keys, nullptr, keys_out, order_out, scratch, \
                               scratch_values, rows, m, queries, cuts, nq,  \
                               static_cast<cudaStream_t>(stream));          \
  }

SORT_PARTITION_KV_ENTRY(f32, float)
SORT_PARTITION_KV_ENTRY(i32, int)
SORT_PARTITION_KV_ENTRY(bf16, __nv_bfloat16)
