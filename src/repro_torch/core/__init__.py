"""SMMS on the port (counterpart of ``repro.core``): (alpha, k)
accounting, Algorithm 1, the flat Round-3 exchange and the SMMS body."""
from .alpha_k import (AlphaKReport, PhaseStats, report_fields, smms_k_bound,
                      smms_workload_bound)
from .boundaries import boundaries, boundaries_oracle, equidepth_samples
from .exchange import (PAD, ExchangeResult, exchange_sorted_segments,
                       flat_receive_capacity, partition_sorted)
from .smms import SortResult, default_cap_factor, smms_shard, smms_sort

__all__ = ["AlphaKReport", "PhaseStats", "report_fields", "smms_k_bound",
           "smms_workload_bound", "boundaries", "boundaries_oracle",
           "equidepth_samples", "PAD", "ExchangeResult",
           "exchange_sorted_segments", "flat_receive_capacity",
           "partition_sorted", "SortResult", "default_cap_factor",
           "smms_shard", "smms_sort"]
