"""Model configurations of the port (counterpart of ``repro.configs``):
the five architectures its dense serving path runs (musicgen-medium's
audio front end is the reference's stub: codes in as tokens)."""
from .base import ArchConfig, MoEConfig, SSMConfig
from .registry import ARCHS, get_arch, smoke_config

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ARCHS", "get_arch",
           "smoke_config"]
