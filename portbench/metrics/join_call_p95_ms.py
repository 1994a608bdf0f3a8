"""The 95th percentile latency of the join calls in the traced window
(host clock around each call, ended by a device synchronize)."""
from portbench.harness import p95

UNIT = "ms"


def read(run):
    if run.op != "join" or not run.latencies_s:
        return None
    return 1e3 * p95(run.latencies_s)
