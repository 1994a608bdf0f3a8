// Row-wise ascending bitonic sort of a (rows, m) array, padded to a power
// of two with the sort sentinel, of keys alone (bitonic_sort_*) or of
// (key, int32 value) pairs in lexicographic order (bitonic_sort_kv_*).
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
// 227 KB of shared memory, so both sorts run one launch a call
// (sort_tiles.cuh row_sort): a row of up to 8,192 padded slots a CTA, a
// row of 2^14-2^16 a cluster of 2-8 CTAs whose shared memory holds it
// (distributed shared memory), the network in register rounds of up to
// five substages on 32 slots a thread (30 rounds a row at 2^16, where
// the network has 136 substages), each slot one unsigned word compared
// in one instruction unless the row holds a NaN key.  Keys alone sort as
// 32-bit words (the key integer; bf16 its key integer over its bits; a
// float32 row whose keys fold to zero 64-bit words compared on the key
// half, so that +-0 and denormals keep the network's order); pairs as
// 64-bit words, or 32-bit ones for bf16 keys with the order generated.
// The kernel reads the caller's unpadded keys (and values) once and
// writes the real positions once; the pads, and with no values the
// order channel (the column: the stable argsort), are made as the row
// is loaded.  At (64, 65536) f32 the keys-only sort moves 32 MiB where
// the split schedule it replaces moved ~640 MiB in 10 launches, so
// both sorts are bound by their shared-memory rounds and their
// compare-exchanges.  Rows past 2^16 padded slots (direct calls only:
// the dispatch sends them to the radix sort) are padded into a scratch
// the wrapper allocates and sorted there by the split schedule
// (sort_tiles.cuh tile_stages / global_substage).
//
// Keys are float32, int32 or bf16.  A bf16 key travels as bf16 and is
// widened to float32 in registers to be compared (network.cuh cmp_key),
// so a bf16 pass moves fewer bytes.
#include "sort_tiles.cuh"

using namespace repro;

// keys: (rows, m) in; keys_out: (rows, m) out; scratch: (rows, pow2 >=
// m), read only past 2^16 padded slots.
#define SORT_ENTRY(SUFFIX, T)                                               \
  extern "C" int bitonic_sort_##SUFFIX(const T* keys, T* keys_out,          \
                                       T* scratch, long long rows,          \
                                       long long m, void* stream) {         \
    return sort_unpadded<T, false, false>(                                  \
        keys, nullptr, keys_out, nullptr, scratch, nullptr, rows, m,        \
        nullptr, nullptr, 0, static_cast<cudaStream_t>(stream));            \
  }

SORT_ENTRY(f32, float)
SORT_ENTRY(i32, int)
SORT_ENTRY(bf16, __nv_bfloat16)

// keys, values: (rows, m) in (values null: the order is generated, the
// stable argsort); keys_out, order_out: (rows, m) out; scratch,
// scratch_values: (rows, pow2 >= m), read only past 2^16 padded slots.
#define PAIR_SORT_ENTRY(SUFFIX, T)                                          \
  extern "C" int bitonic_sort_kv_##SUFFIX(                                  \
      const T* keys, const int* values, T* keys_out, int* order_out,        \
      T* scratch, int* scratch_values, long long rows, long long m,         \
      void* stream) {                                                       \
    return sort_unpadded<T, true, false>(                                   \
        keys, values, keys_out, order_out, scratch, scratch_values, rows,   \
        m, nullptr, nullptr, 0, static_cast<cudaStream_t>(stream));         \
  }

PAIR_SORT_ENTRY(f32, float)
PAIR_SORT_ENTRY(i32, int)
PAIR_SORT_ENTRY(bf16, __nv_bfloat16)
