"""Skew-aware query planner of the port (counterpart of
``repro.planner``): sketches, cost model, plan cache.

A sketch round on the card summarizes every shard (heavy hitters,
CountMin, KMV distinct counts) into a
:class:`~repro_torch.planner.sketch.TableProfile`; the cost model in
:mod:`repro_torch.planner.cost` turns the paper's theorem bounds into a
predicted (alpha, k, bytes shuffled, peak receive) per algorithm; and
:mod:`repro_torch.planner.plan` scores the candidates, caches the
decision under a fingerprint of the input, and hands ``cluster.sort``
/ ``cluster.join`` the winner when the caller says
``algorithm="auto"``, and ``cluster.moe_dispatch`` its mode under
``mode="auto"`` (the routing ids sketched, the dispatch modes scored).
"""
from .cost import (CostEstimate, choose_exchange, exchange_costs, join_costs,
                   moe_dispatch_costs, select, select_dispatch, sort_costs)
from .plan import (QueryPlan, clear_plan_cache, plan_join_query,
                   plan_moe_query, plan_sort_query, planner_stats)
from .sketch import (DataProfile, TableProfile, countmin_query,
                     expert_counts_estimate, misra_gries,
                     profile_join_tables, profile_sorted_shards,
                     shard_sketch, sketch_table)

__all__ = [
    "CostEstimate", "sort_costs", "join_costs", "select",
    "moe_dispatch_costs", "select_dispatch", "expert_counts_estimate",
    "choose_exchange", "exchange_costs",
    "QueryPlan", "plan_sort_query", "plan_join_query", "plan_moe_query",
    "clear_plan_cache", "planner_stats",
    "TableProfile", "DataProfile", "misra_gries", "countmin_query",
    "shard_sketch", "sketch_table", "profile_join_tables",
    "profile_sorted_shards",
]
