"""Synthetic inputs, numpy copies of ``repro.data`` (counterpart), and
the training pipeline (``pipeline.py``)."""
from .pipeline import TokenPipeline, smms_length_bucketing
from .synthetic import (lidar_like, scalar_skew_tables, uniform_keys,
                        zipf_keys, zipf_tables)

__all__ = ["TokenPipeline", "smms_length_bucketing", "uniform_keys",
           "lidar_like", "zipf_tables", "zipf_keys", "scalar_skew_tables"]
