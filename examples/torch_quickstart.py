"""Quickstart on the PyTorch/CUDA port: the paper's algorithms in five
minutes.

The counterpart of ``quickstart.py``: the same steps, data and sizes
through ``repro_torch``'s cluster front door -- one dispatch, one
(alpha, k) report format for every algorithm -- on the card, or on the
CPU with ``--device cpu`` (the kernels' plain versions).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``main`` returns what it printed: the reports and the sorted keys.
"""
import argparse

import numpy as np

from repro_torch import cluster
from repro_torch.data import lidar_like, scalar_skew_tables


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default: raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = cluster.resolve_device(args.device)

    # ---- 1. SMMS: deterministic balanced distributed sort ------------------
    t, m = 8, 4096
    x = lidar_like(t * m, seed=0).reshape(t, m)   # skewed 'real' data
    (sorted_keys, _), report = cluster.sort(x, algorithm="smms", r=2,
                                            device=dev)
    keys = sorted_keys.cpu().numpy()
    assert np.all(np.diff(keys) >= 0)
    print(f"SMMS     : sorted {t*m} keys on {t} machines | "
          f"imbalance {report.imbalance:.3f} (optimal 1.0) | "
          f"alpha={report.alpha}")

    # ---- 2. Terasort baseline: randomized, weaker balance ------------------
    (ts_keys, _), rep_ts = cluster.sort(x, algorithm="terasort", seed=0,
                                        device=dev)
    print(f"Terasort : imbalance {rep_ts.imbalance:.3f}  "
          f"(paper: SMMS beats this by design — Thm 1 vs Thm 3)")

    # ---- 3. Skew join: one hot key, every algorithm ------------------------
    n = 4000
    s_keys, t_keys = scalar_skew_tables(n, m_hot=400, n_hot=100, seed=1)
    rows = np.arange(n)

    outputs, reports = {}, {}
    for alg in cluster.JOIN_ALGORITHMS:
        outputs[alg], reports[alg] = cluster.join(
            s_keys, rows, t_keys, rows, algorithm=alg, t_machines=8,
            device=dev)
    print(f"Skew join imbalance: "
          f"repartition {reports['repartition'].imbalance:.2f}  "
          f"randjoin {reports['randjoin'].imbalance:.2f}  "
          f"statjoin {reports['statjoin'].imbalance:.2f}  "
          f"broadcast {reports['broadcast'].imbalance:.2f}  "
          f"(lower = better, 1.0 ideal)")
    print("Repartition pins the hot key to ONE machine; the others "
          "spread it (Cor 3 / Thm 6 / replication).")

    # ---- 4. Or let the planner decide --------------------------------------
    auto_out, rep = cluster.join(s_keys, rows, t_keys, rows,
                                 algorithm="auto", t_machines=8, device=dev)
    print(f"auto     : planner chose {rep.query_plan.algorithm!r} "
          f"(predicted k={rep.predicted_k:.2f}, "
          f"measured k={rep.k_workload:.2f})")
    return {"smms": (keys, report),
            "terasort": (ts_keys.cpu().numpy(), rep_ts),
            "joins": {alg: (outputs[alg], reports[alg])
                      for alg in reports},
            "auto": (auto_out, rep)}


if __name__ == "__main__":
    main()
