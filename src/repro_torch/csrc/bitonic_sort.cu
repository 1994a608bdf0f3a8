// Row-wise ascending bitonic sort of a (rows, n) array, n a power of two,
// of keys alone (bitonic_sort_*) or of (key, int32 value) pairs in
// lexicographic order (bitonic_sort_kv_*).
//
// Replaces: src/repro/kernels/bitonic.py bitonic_sort (pallas_call at
// :224; body _sort_kernel :169 -> sort_network_block :112) and
// bitonic_sort_kv (pallas_call at :254; body _sort_kv_kernel :173 ->
// sort_network_block_kv -> _compare_exchange_kv :89).  Same network,
// same pairs, same directions, same swap rule, so the result is bitwise
// the one of the plain versions in repro_torch/kernels/bitonic.py, ties
// between equal-comparing values (-0.0, +0.0, denormals) included.  Fed
// values = arange(n), the pair sort is the stable argsort: every pair
// is distinct, so the order is the lexicographic one whatever the
// network.
//
// What bounds it on the H100.  The TPU kernel keeps a whole row (up to
// 2^16 lanes, 256 KiB of f32) in VMEM.  A Hopper block has at most
// 227 KB of shared memory and the main path's rows are exactly 2^16
// f32, so a row cannot stay on chip.  The network is split between
// shared-memory tiles of 8192 elements and one global pass per larger
// substage (sort_tiles.cuh).  At (64, 65536) f32 that is 10 launches
// and about 10 round trips of the 16 MiB array, so it is bound by
// device-memory bytes of those passes plus shared-memory traffic, not
// by the 2 x 16 MiB the sort must move.  A row is spread over
// n / 8192 blocks (8 at the main path's width, 512 blocks in all), so
// 64 rows do not leave most of the 132 SMs idle.
//
// The pair sort runs the same split with a second channel: a tile of
// 8192 pairs needs 64 KiB of shared memory, above the 48 KiB a launch
// gets by default, so the kv entry points raise the kernel's dynamic
// shared-memory limit first (cudaFuncSetAttribute).  It moves twice the
// bytes of the keys-only sort on every pass.
//
// Keys are float32, int32 or bf16.  A bf16 key travels as bf16 (a tile
// of 8192 is 16 KiB) and is widened to float32 in registers to be
// compared (network.cuh cmp_key), so a bf16 pass moves half the bytes.
#include "sort_tiles.cuh"

using namespace repro;

namespace {

template <typename T, bool KV>
int sort_only(T* x, int* v, long long rows, long long n, void* stream) {
  return sort_rows<T, KV>(x, v, rows, n, TileSearch<T>{nullptr, nullptr, 0, 0},
                          false, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int bitonic_sort_f32(float* x, long long rows, long long n,
                                void* stream) {
  return sort_only<float, false>(x, nullptr, rows, n, stream);
}

extern "C" int bitonic_sort_i32(int* x, long long rows, long long n,
                                void* stream) {
  return sort_only<int, false>(x, nullptr, rows, n, stream);
}

extern "C" int bitonic_sort_kv_f32(float* k, int* v, long long rows,
                                   long long n, void* stream) {
  return sort_only<float, true>(k, v, rows, n, stream);
}

extern "C" int bitonic_sort_kv_i32(int* k, int* v, long long rows,
                                   long long n, void* stream) {
  return sort_only<int, true>(k, v, rows, n, stream);
}

extern "C" int bitonic_sort_bf16(__nv_bfloat16* x, long long rows,
                                 long long n, void* stream) {
  return sort_only<__nv_bfloat16, false>(x, nullptr, rows, n, stream);
}

extern "C" int bitonic_sort_kv_bf16(__nv_bfloat16* k, int* v, long long rows,
                                    long long n, void* stream) {
  return sort_only<__nv_bfloat16, true>(k, v, rows, n, stream);
}
