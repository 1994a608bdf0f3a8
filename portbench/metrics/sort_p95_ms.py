"""The 95th percentile latency of all sort calls in the window (host
clock around each call, ended by a device synchronize), nearest rank."""
from portbench.harness import p95

UNIT = "ms"


def read(run):
    if run.op != "sort" or not run.latencies_s:
        return None
    return 1e3 * p95(run.latencies_s)
