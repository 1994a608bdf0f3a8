"""Serving walkthrough on the PyTorch/CUDA port: sort/join query traffic
and LLM request batching.

The counterpart of ``serve_requests.py``.  Part 1 drives mixed sort/join
traffic through the query-serving engine (``repro_torch.serve.
QueryEngine``): an admission queue, micro-batches, in-flight coalescing
of identical queries, a shared substrate pool and per-request (alpha, k)
reports -- then prints the engine's ServeStats against a sequential
one-shot baseline.

Part 2 plans a queue of prompts with wildly mixed lengths into batches
by the paper's sorting technique (padding waste bounded by the SMMS
k-factor), then prefills and decodes them on gemma-2b's smoke
configuration with random weights from a seed.

    PYTHONPATH=src python examples/torch_serve_requests.py [--device cpu]

``main`` returns what it printed: the query results and stats, the
batch plan and the generated tokens, with the weights and the padded
prompt batches that made them.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import cluster


def serve_cluster_queries(dev) -> dict:
    from repro_torch.data import uniform_keys, zipf_tables
    from repro_torch.serve import QueryEngine, join_query, sort_query
    from repro_torch.serve.query import run_spec

    t = 8
    xs = [uniform_keys(t * 512, seed=s).reshape(t, 512) for s in range(3)]
    sk, tk = zipf_tables(800, 800, theta=0.5, seed=7, domain=100)
    rows = np.arange(800)

    distinct = [sort_query(xs[0], algorithm="smms"),
                sort_query(xs[1], algorithm="auto"),
                sort_query(xs[2], algorithm="terasort"),
                join_query(sk, rows, tk, rows, t_machines=t,
                           algorithm="auto"),
                join_query(sk, rows, tk, rows, t_machines=t,
                           algorithm="statjoin")]
    # serving traffic repeats its hot queries
    rng = np.random.default_rng(0)
    picks = rng.choice(len(distinct), size=40, p=[.35, .25, .15, .15, .10])
    trace = [distinct[i] for i in picks]

    with QueryEngine(max_batch=8, batch_window_s=0.005, device=dev) as eng:
        eng.run(distinct)                      # warm the caches
        t0 = time.time()
        results = eng.run(trace)
        dt_engine = time.time() - t0
        stats = eng.stats()

    t0 = time.time()
    for q in trace[:10]:                       # sequential one-shot sample
        run_spec(q, device=dev)
    dt_oneshot = (time.time() - t0) * len(trace) / 10

    assert all(r.ok for r in results)
    lat = sorted(r.latency_s for r in results)
    print(f"served {len(results)} queries in {dt_engine:.2f}s "
          f"(sequential one-shot ~{dt_oneshot:.2f}s)")
    print(f"  trace qps       {len(results) / max(dt_engine, 1e-9):8.1f}")
    print(f"  p50/p99 latency {lat[len(lat)//2]*1e3:6.1f} / "
          f"{lat[-1]*1e3:6.1f} ms")
    print(f"  coalesced       {stats.coalesced} of {stats.served}")
    print(f"  plan-cache rate {stats.plan_cache_hit_rate:.2f} "
          f"(sketches {stats.sketch_runs})")
    print(f"  recompiles      {stats.compiles} "
          f"(program-cache hits {stats.program_cache_hits})")
    r = results[0]
    print(f"  per-request guarantee: {r.algorithm} alpha={r.report.alpha} "
          f"k_w={r.report.k_workload:.2f} k_n={r.report.k_network:.2f}")
    return {"specs": trace, "picks": picks, "results": results,
            "stats": stats}


def serve_llm_requests(dev) -> dict:
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import LengthBucketScheduler, generate

    cfg = smoke_config(get_arch("gemma-2b"))
    cfg = dataclasses.replace(cfg, vocab_size=1024)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)

    rng = np.random.default_rng(7)
    n_requests = 24
    lengths = np.concatenate([rng.integers(4, 12, 12),
                              rng.integers(40, 64, 12)])
    rng.shuffle(lengths)
    prompts = [rng.integers(0, cfg.vocab_size, l).tolist() for l in lengths]

    sched = LengthBucketScheduler(max_batch=6, buckets=4)
    plan = sched.plan(lengths.tolist())
    naive = [list(range(i, min(i + 6, n_requests)))
             for i in range(0, n_requests, 6)]
    waste = sched.padding_waste(lengths, plan)
    print(f"{n_requests} requests, lengths {lengths.min()}..{lengths.max()}")
    print(f"padding waste: planned {waste:.1%}"
          f" vs naive fifo {sched.padding_waste(lengths, naive):.1%}")

    total, batches, tokens = 0, [], []
    for batch_idx in plan:
        mx = max(lengths[i] for i in batch_idx)
        toks = np.zeros((len(batch_idx), mx), np.int32)
        for row, i in enumerate(batch_idx):
            toks[row, mx - lengths[i]:] = prompts[i]  # left-pad
        out = generate(params, cfg, toks, max_new_tokens=4, device=dev)
        total += out.shape[0]
        batches.append(toks)
        tokens.append(out)
        print(f"  batch of {len(batch_idx):2d} @ len {mx:3d} -> "
              f"generated {out.shape[1]} tokens each")
    assert total == n_requests
    print("all requests served")
    return {"cfg": cfg, "params": params, "lengths": lengths, "plan": plan,
            "padding_waste": waste, "batches": batches, "tokens": tokens}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default: raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = cluster.resolve_device(args.device)
    print("== sort/join query serving ==")
    queries = serve_cluster_queries(dev)
    print("\n== LLM request batching ==")
    llm = serve_llm_requests(dev)
    return {"queries": queries, "llm": llm}


if __name__ == "__main__":
    main()
