"""SMMS, Terasort and the joins on the port (counterpart of
``repro.core``): (alpha, k) accounting, Algorithm 1, Algorithm S, the
flat Round-3 exchange, the SMMS and Terasort bodies, the local
equi-join, StatJoin, RandJoin and the two baselines."""
from .alpha_k import (AlphaKReport, PhaseStats, merge_phase_stats,
                      randjoin_k_bound, report_fields, smms_k_bound,
                      smms_workload_bound, statjoin_k_bound,
                      statjoin_workload_bound, terasort_k_bound,
                      terasort_workload_bound)
from .boundaries import (boundaries, boundaries_oracle, equidepth_samples,
                         interval_pdf)
from .broadcastjoin import broadcast_join
from .exchange import (PAD, ExchangeResult, exchange_sorted_segments,
                       flat_receive_capacity, partition_sorted)
from .localjoin import MASKED_KEY, JoinOutput, join_size, local_equijoin
from .randjoin import choose_ab, draw_assignments, randjoin, randjoin_shard
from .repartition import repartition_join
from .sampling import algorithm_s, draw_uniforms, terasort_sample_count
from .smms import SortResult, default_cap_factor, smms_shard, smms_sort
from .statjoin import (JoinStatistics, Rectangle, StatJoinPlan,
                       collect_statistics, plan_statjoin, statjoin)
from .terasort import terasort_shard, terasort_sort

__all__ = ["AlphaKReport", "PhaseStats", "report_fields", "smms_k_bound",
           "smms_workload_bound", "terasort_k_bound", "statjoin_k_bound",
           "statjoin_workload_bound", "randjoin_k_bound",
           "merge_phase_stats", "boundaries", "boundaries_oracle",
           "equidepth_samples", "interval_pdf", "PAD", "ExchangeResult",
           "exchange_sorted_segments", "flat_receive_capacity",
           "partition_sorted", "SortResult", "default_cap_factor",
           "smms_shard", "smms_sort", "MASKED_KEY", "JoinOutput",
           "join_size", "local_equijoin", "JoinStatistics", "Rectangle",
           "StatJoinPlan", "collect_statistics", "plan_statjoin", "statjoin",
           "repartition_join", "broadcast_join", "terasort_workload_bound",
           "algorithm_s", "draw_uniforms", "terasort_sample_count",
           "terasort_shard", "terasort_sort", "choose_ab",
           "draw_assignments", "randjoin", "randjoin_shard"]
