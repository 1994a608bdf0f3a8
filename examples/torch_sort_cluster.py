"""Distributed sort over a process group -- the port's production path.

The counterpart of ``sort_cluster.py``: the per-machine SMMS bodies the
tests run as one batch execute here on a ``ProcessGroupSubstrate``, the
t = 8 machines spread over the ranks of a ``torch.distributed`` group,
with the (alpha, k) report assembled from the group's collectives.
Run bare, the script makes a group of one rank itself (NCCL on the
card, Gloo with ``--device cpu``; file init in a temporary directory);
under ``torchrun --nproc_per_node=N`` (N dividing 8) each rank joins the
launcher's group.  Every rank receives the whole result; rank 0 prints.

    PYTHONPATH=src python examples/torch_sort_cluster.py [--device cpu]
    PYTHONPATH=src torchrun --nproc_per_node=2 examples/torch_sort_cluster.py --device cpu

The second half sorts the same way through the card's kernels and
through their plain versions on the CPU: the keys are bitwise equal.
``main`` returns the reports and the keys it printed.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import cluster
from repro_torch.cluster import ProcessGroupSubstrate
from repro_torch.core import smms_workload_bound
from repro_torch.data import lidar_like

# the reference's machine count: its example forces an 8-device mesh
MACHINES = 8


def _join_group(dev: torch.device):
    """Initialise the default group unless the caller has; returns the
    temporary directory to remove after destroying a group made here,
    or None (the group is the caller's)."""
    if dist.is_initialized():
        return None
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:          # a torchrun rank
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return ""
    tmp = tempfile.mkdtemp(prefix="torch_sort_cluster_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg",
                            world_size=1, rank=0)
    return tmp


def _run(dev: torch.device, say) -> dict:
    t = MACHINES
    m, r = 1 << 14, 2
    x = lidar_like(t * m, seed=3).reshape(t, m)

    substrate = ProcessGroupSubstrate(("machines", t))
    (keys, _), report = cluster.sort(x, algorithm="smms", r=r,
                                     substrate=substrate, device=dev)
    keys = keys.cpu().numpy()
    assert np.all(np.diff(keys) >= 0) and len(keys) == t * m
    counts = report.workload
    bound = smms_workload_bound(t * m, t, r)
    say(f"machines={t}  ranks={dist.get_world_size()}  n={t*m}  "
        f"max-load={int(counts.max())}  mean={counts.mean():.0f}  "
        f"Thm1-bound={bound:.0f}")
    say(f"imbalance {report.imbalance:.3f} — SMMS on a process group, zero "
        f"drops at the Theorem-1 static capacity "
        f"(cap_factor={report.cap_factor:.3f}, "
        f"{report.capacity_attempts} attempt(s))")
    for p in report.phases:
        say(f"  phase {p.name:22s} max sent {int(np.max(p.sent)):6d}  "
            f"max received {int(np.max(p.received)):6d}")

    # --- the same sort through the kernels and through their plain
    # versions: on a CUDA tensor every dispatch launches the hand-written
    # kernel, on a CPU tensor it runs the kernel's plain PyTorch version
    mk = 1 << 10
    xk = lidar_like(t * mk, seed=3).reshape(t, mk)
    (keys_plain, _), _ = cluster.sort(xk, algorithm="smms", r=r,
                                      device="cpu")
    (keys_ker, _), rep_k = cluster.sort(
        xk, algorithm="smms", r=r,
        substrate=ProcessGroupSubstrate(("machines", t)), device=dev)
    keys_plain, keys_ker = keys_plain.numpy(), keys_ker.cpu().numpy()
    assert np.array_equal(keys_plain.view(np.int32), keys_ker.view(np.int32))
    say(f"kernels on {dev.type} (n={t*mk}): bitwise-identical to the plain "
        f"versions on the CPU, imbalance {rep_k.imbalance:.3f}")
    return {"keys": keys, "report": report, "keys_kernel": keys_ker,
            "keys_plain": keys_plain, "report_kernel": rep_k}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default: raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = cluster.resolve_device(args.device)
    made = _join_group(dev)
    try:
        rank = dist.get_rank()
        return _run(dev, print if rank == 0 else (lambda *a: None))
    finally:
        if made is not None:
            dist.destroy_process_group()
            if made:
                shutil.rmtree(made, ignore_errors=True)


if __name__ == "__main__":
    main()
