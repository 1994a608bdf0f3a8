"""The paper's k of Ineq. (1) (report.k_workload: the largest
machine's workload over a perfectly balanced share), the mean over the
window's sort calls."""
UNIT = "ratio"


def read(run):
    ks = [r.k_workload for r in run.reports]
    if run.op != "sort" or not ks:
        return None
    return sum(ks) / len(ks)
