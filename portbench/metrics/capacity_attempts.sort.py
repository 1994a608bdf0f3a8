"""Capacity attempts a sort call (``report.capacity_attempts``: 1 when
the theorem's first receive tile held every pair), the mean over the
window's calls."""
UNIT = "attempts/call"


def read(run):
    att = [r.capacity_attempts for r in run.reports
           if getattr(r, "capacity_attempts", None) is not None]
    if run.op != "sort" or not att:
        return None
    return sum(att) / len(att)
