"""Where the time of one port SMMS sort goes, on the card.

    PYTHONPATH=src python3 -m repro_torch.profile_smms [--t 64] [--m 65536] [--reps 3]

Builds the kernels, warms up, then runs ``repro_torch.cluster.sort`` on
uniform keys ``--reps`` times under ``torch.profiler`` and prints:
the host wall time per sort, the device time per sort summed over every
CUDA kernel and copy, the device's busy share of the wall time, and the
top device consumers by name.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch import cluster
from repro_torch.data import uniform_keys
from repro_torch.kernels import cuda


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_smms: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cuda.build_all()
    x = uniform_keys(args.t * args.m, seed=0).reshape(args.t, args.m)
    for _ in range(2):
        cluster.sort(x)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            cluster.sort(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.reps
    print(f"card: {smi}")
    print(f"t={args.t} m={args.m} uniform, {args.reps} profiled sorts: host "
          f"wall {wall_ms:.2f} ms/sort, device busy {device_ms:.2f} ms/sort "
          f"({100 * device_ms / wall_ms:.1f}% of wall)")
    print(f"{'device ms/sort':>14} {'calls/sort':>10}  name")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"{e.self_device_time_total / 1e3 / args.reps:14.4f} "
              f"{e.count / args.reps:10.1f}  {e.key[:100]}")


if __name__ == "__main__":
    main()
