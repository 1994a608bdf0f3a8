"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (counterpart of ``repro.kernels``).

CUDA sources live in ``repro_torch/csrc/`` and are built at first use
(:mod:`repro_torch.kernels.cuda`); a CPU tensor never needs them.
"""
from . import cuda, flash_attention, ops, ref
from .bitonic import (bitonic_sort, bitonic_sort_kv, merge_sorted_rows,
                      merge_sorted_rows_argsort, sort_sentinel)
from .bucketize import bucketize_histogram, searchsorted
from .fused import merge_ranks, sort_partition, sort_partition_kv
from .radix import bits_to_key, key_to_bits, radix_sort, radix_sort_plain

__all__ = ["cuda", "flash_attention", "ops", "ref", "bitonic_sort",
           "bitonic_sort_kv", "merge_sorted_rows", "merge_sorted_rows_argsort",
           "sort_sentinel", "searchsorted", "bucketize_histogram",
           "merge_ranks", "sort_partition", "sort_partition_kv",
           "radix_sort", "radix_sort_plain", "key_to_bits", "bits_to_key"]
