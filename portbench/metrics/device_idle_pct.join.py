"""The share of the traced window (the first join call's start to the last
one's end) in which no kernel, copy or memset ran on the card, from
torch.profiler's device events."""
UNIT = "%"


def read(run):
    if run.op != "join" or run.trace is None:
        return None
    return run.trace.idle_pct
