"""Cluster substrate of the port (counterpart of ``repro.cluster``):
the batched substrate and its pool, the instrumented collectives, the
capacity policy and the ``sort`` and ``join`` front doors."""
from .api import JOIN_ALGORITHMS, SORT_ALGORITHMS, join, resolve_device, sort
from .capacity import CapacityOverflowError, CapacityPolicy, run_with_capacity
from .collectives import CollectiveTape
from .substrate import (BatchedSubstrate, SubstratePool, default_pool,
                        recommend_pool_size, reset_default_pool,
                        resolve_substrate)

__all__ = ["sort", "join", "SORT_ALGORITHMS", "JOIN_ALGORITHMS",
           "resolve_device", "CapacityPolicy", "CapacityOverflowError",
           "run_with_capacity", "CollectiveTape", "BatchedSubstrate",
           "SubstratePool", "default_pool", "reset_default_pool",
           "recommend_pool_size", "resolve_substrate"]
