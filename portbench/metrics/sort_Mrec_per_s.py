"""Records sorted a second: the records of every call completed in the
window over the window's seconds (host clock), in millions."""
UNIT = "Mrec/s"


def read(run):
    if run.op != "sort" or run.window_s <= 0:
        return None
    return run.calls * run.items_per_call / run.window_s / 1e6
