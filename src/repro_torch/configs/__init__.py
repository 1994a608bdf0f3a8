"""Model configurations of the port (counterpart of ``repro.configs``):
the four dense architectures its serving path runs."""
from .base import ArchConfig, MoEConfig, SSMConfig
from .registry import ARCHS, get_arch, smoke_config

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ARCHS", "get_arch",
           "smoke_config"]
