"""Skew join walkthrough on the PyTorch/CUDA port: Zipf tables, every
algorithm through the cluster front door, the paper's Fig 11/13
workload distributions printed as histograms -- then
``algorithm="auto"``: the planner sketches the tables, scores the
candidates with the theorem cost model, and picks.

The counterpart of ``skew_join.py``, on the card or, with ``--device
cpu``, on the CPU (the kernels' plain versions).

    PYTHONPATH=src python examples/torch_skew_join.py [--device cpu]

``main`` returns what it printed: per theta, each algorithm's output and
report, the auto runs' reports and the result size.
"""
import argparse
import collections

import numpy as np

from repro_torch import cluster
from repro_torch.data import zipf_tables


def bar(w, width=40):
    mx = max(w)
    return "\n".join(
        "  M%-2d |%s %d" % (i, "#" * int(width * v / max(mx, 1)), v)
        for i, v in enumerate(w))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default: raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = cluster.resolve_device(args.device)

    out = {}
    n, t = 3000, 8
    for theta in (0.0, 1.0):
        s_keys, t_keys = zipf_tables(n, n, theta=theta, seed=2, domain=150)
        rows = np.arange(n)
        cs = collections.Counter(s_keys.tolist())
        ct = collections.Counter(t_keys.tolist())
        w = sum(cs[k] * ct[k] for k in cs if k in ct)

        print(f"\n=== Zipf theta={theta} "
              f"({'skewed' if theta < 0.5 else 'uniform'}), |result|={w} ===")
        runs = {}
        for alg, note in (("repartition", ""), ("randjoin", ""),
                          ("broadcast", ""),
                          ("statjoin", " (Thm 6 bound: 2.0)")):
            runs[alg] = cluster.join(s_keys, rows, t_keys, rows,
                                     algorithm=alg, t_machines=t, device=dev)
            rep = runs[alg][1]
            print(f"[{alg:11s}]  imbalance {rep.imbalance:.2f}{note}")
            print(bar(rep.workload))

        # ---- the self-driving path: sketch -> cost model -> dispatch ----
        _, rep = cluster.join(s_keys, rows, t_keys, rows, algorithm="auto",
                              t_machines=t, device=dev)
        print(f"[auto       ]  chose {rep.query_plan.algorithm!r}: "
              f"predicted (alpha={rep.predicted_alpha}, "
              f"k={rep.predicted_k:.2f}) vs measured "
              f"(alpha={rep.alpha}, k={rep.k_workload:.2f})")
        print(rep.query_plan.summary())
        # a repeated query over the same tables hits the plan cache and
        # skips the sketch round entirely
        _, rep2 = cluster.join(s_keys, rows, t_keys, rows, algorithm="auto",
                               t_machines=t, device=dev)
        print(f"  (second run: cached={rep2.query_plan.cached}, "
              f"sketch rounds={len(rep2.sketch_phases)})")
        out[theta] = {"W": w, "runs": runs, "auto": rep, "auto_again": rep2}
    return out


if __name__ == "__main__":
    main()
