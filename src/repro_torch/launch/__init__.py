"""Launch helpers of the port (counterpart of ``repro.launch``): the
staged exchange's shard factorization, the H100 roofline, the step
builders and the training loop (``launch.train``, imported on use)."""
from .mesh import STAGED_AXIS_NAMES, factor_shards

__all__ = ["STAGED_AXIS_NAMES", "factor_shards"]
