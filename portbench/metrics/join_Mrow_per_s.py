"""Input rows joined a second: |S| + |T| of every join completed in the
window over the window's seconds (host clock), in millions."""
UNIT = "Mrow/s"


def read(run):
    if run.op != "join" or run.window_s <= 0:
        return None
    return run.calls * run.items_per_call / run.window_s / 1e6
