"""Launch helpers of the port (counterpart of ``repro.launch``): the
staged exchange's shard factorization."""
from .mesh import STAGED_AXIS_NAMES, factor_shards

__all__ = ["STAGED_AXIS_NAMES", "factor_shards"]
