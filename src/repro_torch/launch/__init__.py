"""Launch helpers of the port (counterpart of ``repro.launch``): the
staged exchange's shard factorization and its mesh, the H100 roofline, the step
builders and the training loop (``launch.train``, imported on use)."""
from .mesh import (STAGED_AXIS_NAMES, factor_shards, make_staged_mesh,
                   staged_axes)

__all__ = ["STAGED_AXIS_NAMES", "factor_shards", "make_staged_mesh",
           "staged_axes"]
