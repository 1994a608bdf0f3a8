"""Serving of the port (counterpart of ``repro.serve``): the sort/join
query engine and greedy generation on the dense LM.

``repro_torch.serve.query`` is the front door for cluster traffic
(admission queue, micro-batching, coalescing, the result cache,
ServeStats); ``repro_torch.serve.engine`` the LM's prefill + decode
loop; ``batching`` the SMMS length-bucket scheduler and the
continuous batcher.

``generate`` pulls in the model stack, so it is re-exported lazily
(PEP 562): importing the query engine does not import the models.
"""
from .batching import ContinuousBatcher, LengthBucketScheduler
from .query import (PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL,
                    AdmissionError, DeadlineExceededError, EngineClosedError,
                    EngineReplicas, QueryEngine, QueryResult, QuerySpec,
                    ResultCache, ResultTimeout, ServeStats, ShedError,
                    join_query, run_spec, sort_query)

__all__ = [
    "LengthBucketScheduler", "ContinuousBatcher", "generate",
    "QueryEngine", "EngineReplicas", "QuerySpec", "QueryResult",
    "ServeStats", "ResultCache",
    "AdmissionError", "EngineClosedError", "ShedError",
    "DeadlineExceededError", "ResultTimeout",
    "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_LOW",
    "sort_query", "join_query", "run_spec",
]


def __getattr__(name):
    if name == "generate":
        from .engine import generate
        return generate
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
