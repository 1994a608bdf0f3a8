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
// version's), and the search is fused into the network's last launch:
// each 8192-element tile of the sorted row counts its own elements below
// each query and adds the count to the row's cut (sort_tiles.cuh).  For
// a sorted row the reference's guarded binary search returns exactly
// that count, so the cuts are bitwise the plain version's.  Fed
// v = arange(m) padded with int32 max, as the reference pads it
// (fused.py:111-112), the pair sort's value channel is the stable
// argsort.
//
// What bounds it on the H100: the sort, as for bitonic_sort.cu (device
// bytes of its global passes plus shared-memory traffic for rows past
// one tile).  The search adds nq lower bounds of at most 13 steps per
// tile in shared memory and one atomic add per (tile, query): for
// Terasort's Round 3 at (64, 65536) with 63 queries, 32,256 atomics,
// against the reference's separate search pass over the sorted row.
// Rows of 8192 or fewer (RandJoin's routing at (64, 2048)) take one
// launch of one block per row, after the cuts are cleared.  Keys are
// float32, int32 or bf16 (compared as float32, network.cuh cmp_key).
#include "sort_tiles.cuh"

using namespace repro;

namespace {

template <typename T, bool KV>
int sort_partition_rows(T* x, int* v, const T* queries, int* cuts,
                        long long rows, long long n, long long m,
                        long long nq, void* stream) {
  return sort_rows<T, KV>(x, v, rows, n, TileSearch<T>{queries, cuts, m, nq},
                          true, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int sort_partition_f32(float* x, const float* queries, int* cuts,
                                  long long rows, long long n, long long m,
                                  long long nq, void* stream) {
  return sort_partition_rows<float, false>(x, nullptr, queries, cuts, rows, n,
                                           m, nq, stream);
}

extern "C" int sort_partition_i32(int* x, const int* queries, int* cuts,
                                  long long rows, long long n, long long m,
                                  long long nq, void* stream) {
  return sort_partition_rows<int, false>(x, nullptr, queries, cuts, rows, n,
                                         m, nq, stream);
}

extern "C" int sort_partition_kv_f32(float* k, int* v, const float* queries,
                                     int* cuts, long long rows, long long n,
                                     long long m, long long nq, void* stream) {
  return sort_partition_rows<float, true>(k, v, queries, cuts, rows, n, m, nq,
                                          stream);
}

extern "C" int sort_partition_kv_i32(int* k, int* v, const int* queries,
                                     int* cuts, long long rows, long long n,
                                     long long m, long long nq, void* stream) {
  return sort_partition_rows<int, true>(k, v, queries, cuts, rows, n, m, nq,
                                        stream);
}

extern "C" int sort_partition_bf16(__nv_bfloat16* x,
                                   const __nv_bfloat16* queries, int* cuts,
                                   long long rows, long long n, long long m,
                                   long long nq, void* stream) {
  return sort_partition_rows<__nv_bfloat16, false>(x, nullptr, queries, cuts,
                                                   rows, n, m, nq, stream);
}

extern "C" int sort_partition_kv_bf16(__nv_bfloat16* k, int* v,
                                      const __nv_bfloat16* queries, int* cuts,
                                      long long rows, long long n,
                                      long long m, long long nq,
                                      void* stream) {
  return sort_partition_rows<__nv_bfloat16, true>(k, v, queries, cuts, rows,
                                                  n, m, nq, stream);
}
