"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* the configuration: the file its entry names
  (``portbench/configs/<config>.json``);
* the traffic mix: ``portbench/traffic/<traffic>.json``;
* each metric: ``portbench/metrics/<metric>.py``, a reader
  ``read(run) -> float | None`` of the :class:`Run` record; a reader
  that finds nothing returns None and the metric is left out of the
  line.  A reader of a program entry's device time names the entry
  (``ENTRY = "module:function"``) and the bytes of each of its calls
  (``bytes_of(args, kwargs) -> (valid 0-d tensor, bytes a valid
  entry)``); in a traced run the harness wraps that entry in a
  ``record_function`` range and counts its bytes on the device.

The window is a closed loop: one client issues back-to-back calls
through the front door, each ended by a device synchronize, for
``seconds`` seconds (the last call may end past the deadline: the
window runs to its end); a traced run's window is at most
:data:`TRACE_SECONDS` long, all of it under the profiler.  For each
input of the pool one call of the window keeps its answer on the
device, drawn from the seed over all of that input's calls
(:class:`Reservoir`); once the window has closed and the peak memory is
read, those answers are compared with the plain reference
(``portbench/reference/``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import devtrace
from portbench.generator import make_workload

__all__ = ["Run", "Bench", "Reservoir", "run_cell", "p95",
           "FORBIDDEN_MODULES", "forbidden_loaded", "WARMUP_CALLS"]

WARMUP_CALLS = 3        # pool inputs 0, 1, 0: every shape of the cell
TRACE_SECONDS = 20.0    # a traced run's window: the profiler's events of a
                        # longer one (~2,300 a call) outgrow its buffers
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level names (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def p95(values) -> Optional[float]:
    """The 95th percentile by nearest rank: the ceil(0.95 n)-th smallest."""
    if len(values) == 0:
        return None
    v = sorted(values)
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    op: str
    setup_s: float
    window_s: float
    latencies_s: List[float]
    items_per_call: int
    input_bytes: int
    reports: List[Any]
    memory_peak_bytes: Optional[int]     # None off the card
    held_bytes: int                      # the sampled answers kept
    trace: Optional[devtrace.DeviceTrace] = None
    entry_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def calls(self) -> int:
        return len(self.latencies_s)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = self.root / "portbench"

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def metrics_of(self, cell: str, per_layer: bool) -> List[str]:
        """The cell's end-to-end metrics (those that list it under
        ``workloads``, or list none), or its per-layer ones (those that
        list it: a per-layer metric always names its cells)."""
        if per_layer:
            return [m["name"] for m in self.spec["per_layer"]
                    if cell in m["workloads"]]
        return [m["name"] for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.pkg / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


class Reservoir:
    """One answer kept per pool input, drawn from the seed uniformly over
    all of that input's calls in the window (reservoir sampling): the
    j-th call of an input replaces the kept answer with chance 1/j, so
    a call late in the window is as likely to be checked as the first.
    At most one answer per input is held at a time."""

    def __init__(self, seed: int, pool: int):
        self.rng = np.random.default_rng([int(seed), 7])
        self.seen = [0] * pool
        self.kept: Dict[int, tuple] = {}     # input -> (call, answer)

    def offer(self, call: int, pool_input: int, answer_of: Callable):
        """Count the call; keep its answer (``answer_of()``, None for a
        call that gave none) if the draw picks it."""
        self.seen[pool_input] += 1
        if self.rng.random() * self.seen[pool_input] < 1.0:
            self.kept.pop(pool_input, None)
            self.kept[pool_input] = (call, answer_of())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _held_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``, rounded up to
    the caching allocator's 512-byte blocks."""
    seen = {}
    for x in tensors:
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
    return int(sum(seen.values()))


class _EntryWraps:
    """The program entries a traced run's readers time: each wrapped in
    a ``record_function`` range with a mark before and after it
    (``devtrace``), its bytes counted on the device outside the range
    (no host read until the window has closed)."""

    def __init__(self, readers: Dict[str, Any], device: torch.device):
        self.flag = torch.zeros(1, dtype=torch.int32, device=device)
        self.by_entry: Dict[str, list] = {}
        for name, mod in readers.items():
            if hasattr(mod, "ENTRY"):
                self.by_entry.setdefault(mod.ENTRY, []).append((name, mod))
        self.totals: Dict[str, Any] = {}
        self.saved = []

    def __enter__(self):
        for entry, users in self.by_entry.items():
            mod_name, attr = entry.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(entry, orig, users))
        return self

    def _wrap(self, entry: str, orig: Callable, users):
        label = devtrace.ENTRY + entry
        totals = self.totals

        flag = self.flag

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                devtrace.mark(flag)
                out = orig(*args, **kwargs)
                devtrace.mark(flag)
            for name, mod in users:
                valid, width = mod.bytes_of(args, kwargs)
                add = valid.to(torch.float64) * float(width)
                totals[name] = add if name not in totals else totals[name] + add
            return out
        return wrapped

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        return False

    def bytes_read(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.totals.items()}


def run_cell(root, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", front=None, config_overrides=None,
             t_start: Optional[float] = None) -> Dict[str, Any]:
    """One run of one cell; returns the result object (the line's keys).

    ``front``: the module whose ``sort`` / ``join`` are the system under
    test (``repro_torch.cluster`` when None).  ``config_overrides``
    replace configuration keys (tests shrink the scale with it).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(cell_name)
    config = dict(bench.config(cell["config"]), **(config_overrides or {}))
    traffic = bench.traffic(cell["traffic"])
    names = bench.metrics_of(cell_name, per_layer=trace)
    readers = {n: bench.reader(n) for n in names}
    if front is None:
        front = importlib.import_module("repro_torch.cluster")
    dev = torch.device(device)
    torch.set_num_threads(1)
    stamps = [("start", t_start), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        from repro_torch.kernels import cuda as kernels
        kernels.build_all()             # at once; only the first run builds
        torch.cuda.init()
    stamps.append(("kernels and card", time.perf_counter()))

    wl = make_workload(config, traffic, seed, dev, front)
    _sync(dev)
    stamps.append(("inputs", time.perf_counter()))
    for i in range(WARMUP_CALLS):
        out, _ = wl.call(i)
        _sync(dev)
        del out
    stamps.append(("warm-up", time.perf_counter()))
    pool = len(wl.pool)
    sample = Reservoir(seed, pool)
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    latencies, reports, failures = [], [], []
    wraps = _EntryWraps(readers, dev) if trace else None
    prof = None
    if trace:
        wraps.__enter__()
        if dev.type == "cuda":
            prof = devtrace.open_window()
        else:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.start()
    setup_s = time.perf_counter() - t_start
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    t0 = time.perf_counter()
    t1 = t0
    i = 0
    while t1 - t0 < seconds or i < pool:
        a = time.perf_counter()
        try:
            with torch.profiler.record_function(devtrace.CALL):
                out, report = wl.call(WARMUP_CALLS + i)
                _sync(dev)
        except Exception as exc:       # a call that never answers
            failures.append(f"call {i}: {type(exc).__name__}: {exc}")
            out = report = None
        t1 = time.perf_counter()
        latencies.append(t1 - a)
        reports.append(report)
        sample.offer(i, (WARMUP_CALLS + i) % pool,
                     lambda: None if out is None else wl.answer(out))
        del out
        i += 1
    window_s = t1 - t0
    dev_trace = None
    if trace:
        if dev.type == "cuda":
            dev_trace = devtrace.close_window(prof)
        else:
            prof.stop()
        wraps.__exit__(None, None, None)
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)
    held = sample.kept
    held_bytes = _held_bytes(x for _, ans in held.values()
                             if ans is not None for x in ans)
    found = forbidden_loaded()
    if found:
        raise SystemExit(f"portbench: loaded in the run's process: "
                         f"{', '.join(found)} (JAX or the JAX package)")

    run = Run(cell=cell, config=config, traffic=traffic, op=wl.op,
              setup_s=setup_s, window_s=window_s,
              latencies_s=latencies, items_per_call=wl.items_per_call,
              input_bytes=wl.input_bytes,
              reports=[r for r in reports if r is not None],
              memory_peak_bytes=peak, held_bytes=held_bytes, trace=dev_trace,
              entry_bytes=wraps.bytes_read() if trace else {})

    # the check, once the peak is read and nothing of the window is left
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks: Dict[str, Dict[str, int]] = {}
    missing = [p for p in range(pool)
               if p not in held or held[p][1] is None]
    checked = []
    for p in sorted(held):
        i, answer = held.pop(p)
        if answer is None:
            continue
        checked.append(i)
        numbers = wl.check(WARMUP_CALLS + i, answer)
        del answer
        for k, v in numbers.items():
            prev = checks.get(k, {"value": 0, "limit": 0})["value"]
            checks[k] = {"value": max(prev, v), "limit": 0}
    checks["answers_missing"] = {"value": len(missing), "limit": 0}
    checks["calls_failed"] = {"value": len(failures), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for name, mod in readers.items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    result = {"correct": bool(correct), "attempted": len(latencies),
              "failed": len(failures), "metrics": metrics,
              "device": _device_info(dev, run)}
    if dev_trace is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in dev_trace.device_ops],
            "idle_gaps": [[n, s] for n, s in dev_trace.idle_gaps]}
    result["checks"] = checks
    for f in failures[:5]:
        print(f"portbench: {f}", file=sys.stderr)
    print(f"portbench: checked window calls {sorted(checked)} of "
          f"{len(latencies)}", file=sys.stderr)
    print("portbench: set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(stamps,
                                                            stamps[1:])),
        file=sys.stderr)
    return result


def _device_info(dev: torch.device, run: Run) -> Dict[str, Any]:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": run.memory_peak_bytes,
            "power_limit": _power_limit()}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def _power_limit() -> Optional[str]:
    """nvidia-smi's power limit of the card, e.g. "700.00 W"."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None
