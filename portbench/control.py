"""The readings that the limits of ``correct`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--program]

For each seed, makes the cell's inputs as a run does and prints, per
pool input, one JSON line of the numbers the check compares:

* ``control``: the reference put in the program's place, computed one
  step below what the configuration states (a sort's keys compared in
  bfloat16 instead of float32; a join through the capped repartition
  join, which drops what a hot key piles past Theorem 6's capacity).
  It has to read above every limit;
* ``program`` (with ``--program``): one call of the program through the
  front door on the same input, the sound reading.

Needs the card; the tests call :func:`readings` on the CPU at a size
they hold.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = str(pathlib.Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p != HERE]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def readings(root, cell_name: str, seed: int, program: bool, device="cuda",
             front=None, config_overrides=None):
    """[(pool input, kind, numbers)] for one seed."""
    import torch

    from portbench.generator import make_workload
    from portbench.harness import Bench

    bench = Bench(root)
    cell = bench.cell(cell_name)
    config = dict(bench.config(cell["config"]), **(config_overrides or {}))
    if program and front is None:
        import importlib
        front = importlib.import_module("repro_torch.cluster")
    wl = make_workload(config, bench.traffic(cell["traffic"]), seed,
                       torch.device(device), front)
    out = []
    for i in range(len(wl.pool)):
        out.append((i, "control", wl.control(i)))
        if program:
            answer = wl.answer(wl.call(i)[0])
            out.append((i, "program", wl.check(i, answer)))
            del answer
    del wl
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        for i, kind, numbers in readings(ROOT, args.workload, seed,
                                         args.program):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "input": i, "kind": kind, **numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
