"""Launch helpers of the port (counterpart of ``repro.launch``): the
production and host meshes, the staged exchange's shard factorization
and its mesh, the H100 roofline, the step builders, the training loop
(``launch.train``, imported on use) and the dry run
(``python -m repro_torch.launch.dryrun``)."""
from .mesh import (STAGED_AXIS_NAMES, factor_shards, make_host_mesh,
                   make_production_mesh, make_staged_mesh, staged_axes)

__all__ = ["STAGED_AXIS_NAMES", "factor_shards", "make_host_mesh",
           "make_production_mesh", "make_staged_mesh", "staged_axes"]
