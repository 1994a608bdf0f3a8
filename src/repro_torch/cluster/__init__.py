"""Cluster substrate of the port (counterpart of ``repro.cluster``):
the batched substrate, the instrumented collectives, the capacity
policy and the ``sort`` and ``join`` front doors."""
from .api import JOIN_ALGORITHMS, SORT_ALGORITHMS, join, resolve_device, sort
from .capacity import CapacityOverflowError, CapacityPolicy, run_with_capacity
from .collectives import CollectiveTape
from .substrate import BatchedSubstrate, default_pool

__all__ = ["sort", "join", "SORT_ALGORITHMS", "JOIN_ALGORITHMS",
           "resolve_device", "CapacityPolicy", "CapacityOverflowError",
           "run_with_capacity", "CollectiveTape", "BatchedSubstrate",
           "default_pool"]
