"""Model configurations of the port (counterpart of ``repro.configs``):
the reference's ten architectures -- five dense ones (musicgen-medium's
audio front end is the reference's stub: codes in as tokens), two MoE
ones (granite-moe-3b-a800m, dbrx-132b), the vision-language
pixtral-12b, the SSM mamba2-130m and the hybrid jamba-1.5-large-398b
-- and the four assigned input shapes (``shapes.py``)."""
from .base import ArchConfig, MoEConfig, SSMConfig
from .registry import ARCHS, get_arch, smoke_config
from .shapes import SHAPES, ShapeSpec, applicable, input_specs, skip_reason

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ARCHS", "get_arch",
           "smoke_config", "SHAPES", "ShapeSpec", "applicable",
           "input_specs", "skip_reason"]
