"""Synthetic inputs, numpy copies of ``repro.data`` (counterpart)."""
from .synthetic import (lidar_like, scalar_skew_tables, uniform_keys,
                        zipf_keys, zipf_tables)

__all__ = ["uniform_keys", "lidar_like", "zipf_tables", "zipf_keys",
           "scalar_skew_tables"]
