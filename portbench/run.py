"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program under test (``src/repro_torch``).  Prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: every number compared with its
limit, which also end standard error.

Exits with a code other than 0, printing no result, when no CUDA card
is present or fewer than the cell asks for, when the program cannot be
imported, and when JAX or the JAX package (``repro``) was loaded in
this process by the time the window closed.  The program's kernels are
built, at the first run only, into ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = str(pathlib.Path(__file__).resolve().parent)
# this folder's own modules are imported as ``portbench.*``, never bare
sys.path[:] = [p for p in sys.path if p != HERE]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.harness import Bench, run_cell

    chips = int(Bench(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch.cluster  # noqa: F401  (the system under test)

    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
