"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on a
fake mesh of 256 (512) ranks, allocating nothing.

Counterpart of ``src/repro/launch/dryrun.py`` (``run_cell``,
``cell_list``, ``main``, the same CLI).  The reference forces 512 host
devices before importing jax, then lowers and compiles each step for
the 16x16 (2x16x16) mesh.  The port has no compiler to ask: in a
process of its own it initialises a fake default process group of 256
or 512 ranks (``FakeStore``, backend ``"fake"``: every collective
returns at once), builds the production mesh over it, and runs the
step once as rank 0 under ``FakeTensorMode`` -- every argument a fake
tensor, laid out by the sharding rules, so each rank's local shards
have their real shapes and the trace runs every op of the step on
them (on fake CPU tensors the kernels' plain twins, shape for shape).
What the trace sees is the record:

* ``memory_per_device``: ``arguments_bytes``, the local shards of the
  parameters, moments and batch (or tokens and cache), exactly;
  ``output_bytes``, those of the step's outputs; ``peak_bytes`` and
  ``temp_bytes`` from ``torch.distributed._tools.mem_tracker.
  MemTracker`` (the arguments plus what the step allocates at its
  peak); ``fits_80GiB_hbm`` (arguments + temporaries below one H100's
  80 GiB), where the reference has ``fits_16GiB_hbm``;
* ``cost_analysis_raw``: ``flops`` (``FlopCounterMode``, the local
  shards' products) and, with the roofline, ``bytes accessed`` (each
  op's operands and results, XLA's measure);
* ``collectives_prod_bytes``: by kind (``all-reduce``, ``all-gather``,
  ...), the bytes of each collective's operand (the gathered result for
  a gather), from the c10d ops the trace issues; ``collective_counts``
  from ``CommDebugMode``;
* ``roofline`` (single pod): ``launch.roofline.RooflineTerms`` of the
  trace -- the whole depth, as the port's step has no scanned body to
  extrapolate from -- with the H100's constants and ``model_flops``;
* ``compile_s``: the trace's seconds.

``step_opts`` (``remat``, ``loss_chunk``, ``moment_dtype``,
``seq_parallel``) go through the step builders' arguments; the
reference's ``cache_write`` has no counterpart (the port writes the
cache in place) and is recorded as ignored.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every cell
  python -m repro_torch.launch.dryrun --all --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

OUT_DIR = os.environ.get("REPRO_DRYRUN_DIR", "experiments/dryrun")
HBM_BYTES = 80 * 1024 ** 3      # one H100
MESH_RANKS = {"single": 256, "multi": 512}

__all__ = ["run_cell", "cell_list", "main", "fake_world"]


def fake_world(ranks: int) -> None:
    """This process as rank 0 of a fake default group of ``ranks``
    ranks (a group already there must have that size)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != ranks:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the dry run needs {ranks}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


_KINDS = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
          "_allgather_base_": "all-gather", "allgather_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "_reduce_scatter_base_": "reduce-scatter",
          "reduce_scatter_": "reduce-scatter",
          "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
          "broadcast_": "broadcast"}


def _nbytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _counters(bytes_accessed: bool):
    """A dispatch mode that sums the collectives' operand bytes by kind
    and, with ``bytes_accessed``, every other op's operand and result
    bytes (views excepted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counters(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.coll = {}
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ns = func.namespace
            name = func._schema.name.split("::")[-1]
            if ns == "c10d":
                kind = _KINDS.get(name, name)
                self.coll[kind] = self.coll.get(kind, 0) + _nbytes(args[0])
            elif bytes_accessed and not func.is_view and ns == "aten":
                self.bytes += _nbytes(list(args)) + _nbytes(
                    out if isinstance(out, (list, tuple)) else [out])
            return out

    return Counters()


def _local_bytes(tree) -> int:
    """The bytes of a tree's tensors as one rank holds them."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _locals(tree):
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             roofline: bool = True, variant: str = "",
             overrides=None, step_opts=None) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..configs import ARCHS, SHAPES, skip_reason
    from ..models.convert import tree_map
    from ..optim.adamw import AdamWConfig, adamw_init
    from .mesh import make_production_mesh
    from .roofline import RooflineTerms, model_flops
    from .steps import (build_step, shard_batch, shard_cache,
                        shard_opt_state, shard_params)

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if overrides:
        overrides = dict(overrides)
        moe_over = overrides.pop("moe", None)
        if moe_over and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    step_kw, ignored = {}, []
    for key, val in (step_opts or {}).items():
        if key == "seq_parallel":
            step_kw["seq_parallel"] = bool(val)
        elif shape.kind == "train" and key in ("remat", "loss_chunk"):
            step_kw[key] = val
        elif shape.kind == "train" and key == "moment_dtype":
            step_kw["adamw"] = AdamWConfig(moment_dtype=getattr(torch, val))
        else:
            ignored.append(key)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "variant": variant, "kind": shape.kind}
    if ignored:
        rec["step_opts_ignored"] = sorted(ignored)
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skip"
        rec["skip_reason"] = reason
        return rec

    fake_world(MESH_RANKS[mesh_kind])
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size()

    # monotonic: an NTP step mid-trace must not corrupt compile_s
    t0 = time.monotonic()
    bundle = build_step(cfg, mesh, shape, **step_kw)
    rules = bundle.rules
    with FakeTensorMode():
        def fake(t):
            return (torch.empty(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t)

        meta = [tree_map(fake, a) for a in bundle.arg_shapes]
        params = shard_params(rules, meta[0])
        if shape.kind == "train":
            opt = shard_opt_state(rules, adamw_init(
                meta[0], step_kw.get("adamw", AdamWConfig())))
            args = (params, opt, shard_batch(rules, meta[2]))
        else:
            tokens = shard_batch(rules, {"tokens": meta[1]})["tokens"]
            args = (params, tokens, shard_cache(rules, meta[2]))
            if len(meta) > 3:
                args += (shard_batch(rules, {"embeds": meta[3]})["embeds"],)
        arguments = _local_bytes(args)
        flops, comm = FlopCounterMode(display=False), CommDebugMode()
        counters = _counters(roofline)
        tracker = peak = None
        try:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            tracker.track_external(*_locals(args))
        except Exception as e:          # noqa: BLE001 -- recorded below
            peak = f"MemTracker unavailable: {type(e).__name__}: {e}"
            tracker = None
        with flops, comm, counters:
            if tracker is not None:
                with tracker:
                    out = bundle.fn(*args)
            else:
                out = bundle.fn(*args)
        if tracker is not None:
            snap = tracker.get_tracker_snapshot("peak")
            peak = int(max(v["Total"] for v in snap.values()))
        output = _local_bytes(out)
    rec["compile_s"] = round(time.monotonic() - t0, 1)
    temp = peak - arguments if isinstance(peak, int) else None
    rec["memory_per_device"] = {
        "arguments_bytes": int(arguments),
        "output_bytes": int(output),
        "temp_bytes": temp,
        "peak_bytes": peak if isinstance(peak, int) else None,
        "fits_80GiB_hbm": (bool(arguments + temp < HBM_BYTES)
                           if temp is not None else None),
    }
    if not isinstance(peak, int):
        rec["memory_per_device"]["peak_reason"] = peak
    rec["cost_analysis_raw"] = {"flops": float(flops.get_total_flops())}
    if roofline:
        rec["cost_analysis_raw"]["bytes accessed"] = float(counters.bytes)
    rec["collectives_prod_bytes"] = {k: float(v)
                                     for k, v in counters.coll.items()}
    rec["collective_counts"] = {str(k): int(v) for k, v in
                                comm.get_comm_counts().items()}
    rec["status"] = "ok"
    if roofline:
        coll = float(sum(counters.coll.values()))
        terms = RooflineTerms(flops=float(flops.get_total_flops()),
                              hbm_bytes=float(counters.bytes),
                              coll_bytes=coll,
                              model_flops=model_flops(cfg, shape))
        rec["roofline"] = terms.summary(chips)
        rec["roofline"]["coll_prod_crosscheck_bytes"] = coll
    return rec


def cell_list(mesh_kind: str):
    from ..configs import ARCHS, SHAPES
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            yield arch, shape, mesh_kind


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="single", choices=["single", "multi"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--no-roofline", action="store_true")
    p.add_argument("--variant", default="",
                   help="label recorded in the JSON (perf experiments)")
    p.add_argument("--override", default="",
                   help="JSON dict of ArchConfig field overrides")
    p.add_argument("--opts", default="",
                   help="JSON dict of step options: remat, loss_chunk, "
                        "moment_dtype, seq_parallel")
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--timeout", type=int, default=2400)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        failures = []
        for arch, shape, mesh in cell_list(args.mesh):
            tag = f"{arch}_{shape}_{mesh}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip existing] {tag}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", args.out]
            if args.no_roofline:
                cmd.append("--no-roofline")
            print(f"[run] {tag}", flush=True)
            try:
                r = subprocess.run(cmd, timeout=args.timeout)
                if r.returncode != 0:
                    failures.append(tag)
            except subprocess.TimeoutExpired:
                failures.append(tag + " (timeout)")
        print("FAILURES:", failures if failures else "none")
        sys.exit(1 if failures else 0)

    roofline = not args.no_roofline and args.mesh == "single"
    overrides = json.loads(args.override) if args.override else None
    step_opts = json.loads(args.opts) if args.opts else None
    try:
        rec = run_cell(args.arch, args.shape, args.mesh,
                       roofline=roofline, variant=args.variant,
                       overrides=overrides, step_opts=step_opts)
    except Exception:                   # noqa: BLE001 -- the record says
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": traceback.format_exc()}
    suffix = f"_{args.variant}" if args.variant else ""
    tag = f"{args.arch}_{args.shape}_{args.mesh}{suffix}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("error",)}, indent=2)[:2000])
    if rec["status"] == "error":
        print(rec["error"][-3000:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
