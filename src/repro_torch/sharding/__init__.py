"""Sharding of the port (counterpart of ``repro.sharding``): the
partition rules (``specs.py``) and the tensor-parallel collectives the
model's sub-blocks run on local shards (``parallel.py``)."""
from .specs import P, ShardingRules, make_rules, placements

__all__ = ["P", "ShardingRules", "make_rules", "placements"]
