"""Cluster substrate of the port (counterpart of ``repro.cluster``):
the batched and the process-group substrates and their pool, the
instrumented collectives, the capacity policy and the ``sort``,
``join`` and ``moe_dispatch`` front doors."""
from . import compat
from .api import (AUTO, JOIN_ALGORITHMS, MOE_DISPATCH_MODES, SORT_ALGORITHMS,
                  join, moe_dispatch, resolve_device, sort)
from .capacity import CapacityOverflowError, CapacityPolicy, run_with_capacity
from .collectives import CollectiveTape, ProcessGroupTape
from .substrate import (BatchedSubstrate, ProcessGroupSubstrate, Substrate,
                        SubstratePool, default_pool, default_substrate,
                        recommend_pool_size, reset_default_pool,
                        resolve_substrate)

__all__ = ["sort", "join", "moe_dispatch", "SORT_ALGORITHMS",
           "JOIN_ALGORITHMS", "MOE_DISPATCH_MODES", "AUTO",
           "resolve_device", "CapacityPolicy", "CapacityOverflowError",
           "run_with_capacity", "CollectiveTape", "ProcessGroupTape",
           "Substrate", "BatchedSubstrate", "ProcessGroupSubstrate",
           "SubstratePool", "default_pool", "default_substrate",
           "reset_default_pool", "recommend_pool_size", "resolve_substrate",
           "compat"]
