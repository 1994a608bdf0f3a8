"""End-to-end tracing walkthrough on the PyTorch/CUDA port: one warm
query, one span tree.

The counterpart of ``traced_query.py``.  Submits a sort query through
``QueryEngine`` with the span tracer enabled, prints the request's span
tree (planner -> substrate -> collective phases -> kernel dispatches),
reconciles the phase leaves against the same execution's (alpha, k)
report, shows the engine's histogram-backed ServeStats, and dumps the
trace as Chrome-trace JSON into a new temporary directory (open it in
chrome://tracing or https://ui.perfetto.dev).

    PYTHONPATH=src python examples/torch_traced_query.py [--device cpu]

``main`` returns what it printed: the result, the stats and the trace
file's path.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import cluster


def main(argv=None) -> dict:
    from repro_torch.cluster import SubstratePool
    from repro_torch.data import uniform_keys
    from repro_torch.obs import Tracer, write_chrome_trace
    from repro_torch.serve import QueryEngine, sort_query
    from repro_torch.serve.query import run_spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default: raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = cluster.resolve_device(args.device)

    t, m = 8, 512
    x = uniform_keys(t * m, seed=5).reshape(t, m)
    spec = sort_query(x, algorithm="auto")   # auto => planner spans too

    pool = SubstratePool()
    run_spec(spec, substrate=pool, device=dev)   # warm the plan cache
    tracer = Tracer(enabled=True)
    with QueryEngine(pool=pool, tracer=tracer, device=dev) as eng:
        res = eng.run([spec])[0]
    assert res.ok, res.error

    print("== span tree ==")
    print(res.trace.tree_str())

    print("== phase spans vs the (alpha, k) report ==")
    spans = {s.name: s for s in res.trace.walk()
             if s.name.startswith("phase:")}
    for ph in res.report.phases:
        sp = spans[f"phase:{ph.name}"]
        ok = (np.array_equal(np.asarray(sp.attrs["sent"]),
                             np.asarray(ph.sent))
              and np.array_equal(np.asarray(sp.attrs["received"]),
                                 np.asarray(ph.received)))
        print(f"  {ph.name:24s} recv/machine={np.asarray(ph.received)}"
              f"  span==report: {ok}")
        assert ok

    st = eng.stats()
    print("== ServeStats (histogram-backed percentiles) ==")
    print(f"  served={st.served} executed={st.executed} "
          f"p50={st.p50_latency_s * 1e3:.1f}ms "
          f"p99={st.p99_latency_s * 1e3:.1f}ms")

    out = os.path.join(tempfile.mkdtemp(prefix="torch_traced_query_"),
                       "TRACE_example.json")
    write_chrome_trace(out, [res.trace])
    print(f"Chrome trace written to {out} "
          "(load in chrome://tracing or ui.perfetto.dev)")
    return {"result": res, "stats": st, "trace_path": out}


if __name__ == "__main__":
    main()
