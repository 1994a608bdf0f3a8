"""Serving of the port (counterpart of ``repro.serve``): greedy
generation on the dense LM (``engine.generate``)."""
from .engine import generate

__all__ = ["generate"]
