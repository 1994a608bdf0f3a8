"""Model configurations of the port (counterpart of ``repro.configs``):
the seven architectures its serving path runs -- five dense ones
(musicgen-medium's audio front end is the reference's stub: codes in as
tokens) and two MoE ones, granite-moe-3b-a800m and dbrx-132b."""
from .base import ArchConfig, MoEConfig, SSMConfig
from .registry import ARCHS, get_arch, smoke_config

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ARCHS", "get_arch",
           "smoke_config"]
