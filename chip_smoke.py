"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch.cluster.sort(x, algorithm="smms")`` -- SMMS with the
flat static exchange, keys only -- at t = 64 machines x m = 65,536 float32
keys (n = 4,194,304) and at t = 8 x m = 4,096, after building the four
hand-written CUDA kernels of that path from ``src/repro_torch/csrc`` and
holding each against its plain PyTorch version on the card.  Phases, in
order; any failure raises and the script exits non-zero without printing
a result:

  1. device     the card's name and power limit (fails without a card)
  2. build      one nvcc per kernel source, all at once; -Xptxas -v
  3. kernels    each kernel vs its plain version, bitwise, at the main
                path's shapes and at edge cases
  4. main path  t=64 x 65,536: uniform, LIDAR-like, Zipf and an
                adversarial placement; keys, workload, alpha, bounds and
                capacity attempts checked on the host
  5. small      t=8 x 4,096 (the in-tile merge), every report field equal
                to the same call on the CPU
  6. launches   every kernel launched during phases 4-5
  7. times      per kernel: CUDA-event time, plain version, one PyTorch
                library call, bound; the end-to-end sort and peak memory

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels, and the one before that the card's name and power
limit.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import cluster  # noqa: E402
from repro_torch.core import flat_receive_capacity  # noqa: E402
from repro_torch.data import lidar_like, uniform_keys, zipf_keys  # noqa: E402
from repro_torch.kernels import bitonic, bucketize, cuda, fused, ops  # noqa: E402

T, M = 64, 65536            # the main path: n = 4,194,304 keys
T_SMALL, M_SMALL = 8, 4096  # the in-tile bitonic merge
SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

KERNELS = {
    "bitonic_sort": dict(
        source="src/repro_torch/csrc/bitonic_sort.cu",
        replaces="src/repro/kernels/bitonic.py:224"),
    "searchsorted": dict(
        source="src/repro_torch/csrc/searchsorted.cu",
        replaces="src/repro/kernels/bucketize.py:145"),
    "merge_rows": dict(
        source="src/repro_torch/csrc/merge_rows.cu",
        replaces="src/repro/kernels/bitonic.py:313"),
    "merge_ranks": dict(
        source="src/repro_torch/csrc/merge_ranks.cu",
        replaces="src/repro/kernels/fused.py:286"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if same_bits(a, b):
        return 0.0
    a, b = a.cpu().double(), b.cpu().double()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return math.inf
    return float((a[both] - b[both]).abs().max())


def event_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch.cuda.get_device_name(0): "
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    t0 = time.perf_counter()
    log = cuda.build_all()
    wall = time.perf_counter() - t0
    print(f"[build] {len(cuda.SOURCES)} kernels in {wall:.1f} s wall "
          f"(one nvcc each, in parallel)")
    for name, entry in log.items():
        print(f"[build] --- {name}: {entry['seconds']:.1f} s; -Xptxas -v:")
        for line in entry["ptxas"].splitlines():
            if "ptxas" in line or "bytes" in line or "registers" in line:
                print(f"[build]   {line.strip()}")
    for name in cuda.SOURCES:       # load every library now
        cuda.library(name)
    return {"wall_s": wall,
            "per_kernel_s": {k: v["seconds"] for k, v in log.items()}}


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------

def _edge_rows(rng, rows, n):
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[0] = rng.choice(np.float32([-1.5, 0.0, 2.25]), size=n)     # duplicates
    x[1] = 3.75                                                   # all equal
    x[2, ::7] = np.inf
    x[2, 3::11] = -np.inf
    tiny = np.float32([1e-40, -0.0, 0.0, -1e-40, 2e-39, -3e-39, 5e-41, -0.0])
    x[3, :min(n, 8)] = tiny[:n]                                   # denormals
    return torch.from_numpy(x)


def _ranked(keys: torch.Tensor):
    """(batch, t, c) sorted rows -> the padded (key, id) rows of _rank_merge."""
    batch, t, c = keys.shape
    kp = bitonic._pad_sorted_rows(keys, math.inf).contiguous()
    tp2, cp2 = kp.shape[-2:]
    ip = bitonic._pad_iota_unique(t, c, tp2, cp2, device=keys.device)
    return kp, ip.expand(batch, tp2, cp2).contiguous()


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version, both on the card."""
    dev = torch.device(DEVICE)
    errs = {}

    def compare(name, label, kernel_out, plain_out):
        ok = same_bits(kernel_out, plain_out)
        err = max_abs_err(kernel_out, plain_out)
        print(f"[kernels] {name:13s} {label:44s} bitwise={ok}")
        check(ok, f"{name} {label}: kernel differs from its plain version "
                  f"(max abs err {err})")
        errs[name] = max(errs.get(name, 0.0), err)

    # bitonic_sort: the main path's (64, 65536) plus edge cases
    x = torch.from_numpy(uniform_keys(T * M, seed=SEED).reshape(T, M)).to(dev)
    compare("bitonic_sort", f"({T}, {M}) f32, the main path",
            bitonic.bitonic_sort(x), bitonic.bitonic_sort_plain(x))
    for rows, n in [(6, 1000), (4, 65536), (5, 3)]:
        e = _edge_rows(rng, rows, n).to(dev)
        compare("bitonic_sort", f"({rows}, {n}) dups/equal/inf/denormals",
                bitonic.bitonic_sort(e), bitonic.bitonic_sort_plain(e))
    xi = torch.from_numpy(rng.integers(-9, 9, (4, 5000)).astype(np.int32))
    xi = xi.to(dev)
    compare("bitonic_sort", "(4, 5000) int32",
            bitonic.bitonic_sort(xi), bitonic.bitonic_sort_plain(xi))

    # searchsorted: 63 boundaries into each sorted (65536,) row
    rows = torch.sort(torch.from_numpy(
        rng.integers(0, 5000, (T, M)).astype(np.float32)), dim=1).values
    rows = rows.to(dev)
    q = torch.from_numpy(rng.integers(-1, 5002, (T, T - 1))
                         .astype(np.float32)).to(dev)
    for side in ("left", "right"):
        compare("searchsorted", f"({T}, {M}) x {T - 1} queries, {side}",
                bucketize.searchsorted(rows, q, side),
                bucketize.searchsorted_plain(rows, q, side))
    padded = ops.pad_pow2(rows[:, :1000]).contiguous()
    bounds = torch.tensor([[-1.0, 7.0, 7.0, 4000.0, math.inf]],
                          device=dev).expand(T, 5).contiguous()
    compare("searchsorted", "valid_len clamp over a sentinel tail",
            ops.searchsorted(padded, bounds[0], valid_len=1000),
            torch.clamp_max(bucketize.searchsorted_plain(padded, bounds),
                            1000))
    es = bitonic.bitonic_sort_plain(_edge_rows(rng, 4, 777)).contiguous().to(dev)
    eq = torch.tensor([[0.0, 1e-40, -math.inf, math.inf]],
                      device=dev).expand(4, 4).contiguous()
    compare("searchsorted", "dups/inf/denormal rows and queries",
            bucketize.searchsorted(es, eq),
            bucketize.searchsorted_plain(es, eq))

    # merge_sorted_rows (in tile): the small configuration's receive rows
    cap = flat_receive_capacity(M_SMALL, T_SMALL,
                                cluster.CapacityPolicy.smms(
                                    T_SMALL * M_SMALL, T_SMALL,
                                    2).first_factor) // T_SMALL
    r = torch.sort(torch.from_numpy(rng.standard_normal(
        (T_SMALL, T_SMALL, cap)).astype(np.float32)), dim=-1).values
    r[..., -50:] = math.inf                                  # PAD tails
    r = r.to(dev)
    compare("merge_rows", f"({T_SMALL}, {T_SMALL}, {cap}) receive rows",
            bitonic.merge_sorted_rows(r), bitonic.merge_sorted_rows_plain(r))
    e = torch.sort(_edge_rows(rng, 8, 300), dim=-1).values[None].to(dev)
    compare("merge_rows", "(1, 8, 300) dups/equal/inf/denormals",
            bitonic.merge_sorted_rows(e), bitonic.merge_sorted_rows_plain(e))
    big = torch.sort(torch.from_numpy(rng.standard_normal(
        (2, 16, 4096)).astype(np.float32)), dim=-1).values.to(dev)
    compare("merge_rows", "(2, 16, 4096): global flip and cascade",
            bitonic.merge_sorted_rows(big),
            bitonic.merge_sorted_rows_plain(big))

    # merge_ranks: the main path's (64, 64, 4096), blocked and not
    kp, ip, _ = _main_rank_operands(rng, dev)
    for bb in (ops.RANK_MERGE_BOUND_BLOCK, None):
        compare("merge_ranks", f"{tuple(kp.shape)} bound_block={bb}",
                fused.merge_ranks(kp, ip, bb),
                fused.merge_ranks_plain(kp, ip, bb))
    e = torch.sort(_edge_rows(rng, 8, 300), dim=-1).values[None]
    ke, ie = _ranked(e.to(dev))
    for bb in (64, None):
        compare("merge_ranks", f"(1, 8, 512) edge rows, bound_block={bb}",
                fused.merge_ranks(ke, ie, bb),
                fused.merge_ranks_plain(ke, ie, bb))
    torch.cuda.synchronize()
    return errs


def _main_rank_operands(rng, dev):
    """Receive rows as the full-size main path lands them: 64 machines x
    64 sorted rows of C = 2152 slots, PAD tails, padded to 64 x 4096."""
    cap = flat_receive_capacity(M, T, cluster.CapacityPolicy.smms(
        T * M, T, 2).first_factor) // T
    recv = torch.sort(torch.from_numpy(rng.uniform(
        0, 1, (T, T, cap)).astype(np.float32)), dim=-1).values
    recv[..., 2048:] = math.inf
    recv = recv.to(dev)
    return (*_ranked(recv), recv)


# ---------------------------------------------------------------------------
# 4-5. the main path
# ---------------------------------------------------------------------------

def adversarial_shards(t: int, m: int, hot: int, seed: int) -> np.ndarray:
    """Machine i aims a hot block at machine i+1, the rest dealt evenly.

    The keys are a uniform sample, so Algorithm 1's boundaries fall near
    the global quantiles; machine i holds ``hot`` keys from the middle of
    quantile slice i+1 plus m - hot keys dealt at random.  Pair
    (i, i+1) then carries ~hot + (m - hot)/t keys: past the first
    Theorem-1 tile (C = 2152 at t=64, m=65,536) but within the doubled
    one (4303), so exactly one capacity retry is needed.  The reference's
    whole-shard placement (tests/test_capacity_retry.py) would overflow
    every tile of the retry schedule at this size.
    """
    rng = np.random.default_rng(seed)
    keys = np.sort(uniform_keys(t * m, seed=seed)).reshape(t, m)
    lo = (m - hot) // 2
    hot_blocks = keys[:, lo:lo + hot]
    rest = np.concatenate([keys[:, :lo], keys[:, lo + hot:]], axis=1)
    rest = rng.permutation(rest.reshape(-1)).reshape(t, m - hot)
    shards = np.concatenate([np.roll(hot_blocks, -1, axis=0), rest], axis=1)
    return np.ascontiguousarray(shards, dtype=np.float32)


def check_run(name: str, x: np.ndarray, keys: torch.Tensor, rep,
              attempts: int, theorem1: bool = True) -> None:
    t, m = x.shape
    n = t * m
    got = keys.cpu().numpy()
    want = np.sort(x.reshape(-1))
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          f"{name}: keys differ from np.sort of the input")
    interior = rep.boundaries[1:-1]
    cuts = np.searchsorted(want, interior, side="left")
    recount = np.diff(np.concatenate([[0], cuts, [n]]))
    check(np.array_equal(np.asarray(rep.workload), recount),
          f"{name}: workload {rep.workload} != host recount {recount}")
    check(int(np.sum(rep.workload)) == n, f"{name}: sum(workload) != n")
    check(rep.alpha == 3, f"{name}: alpha {rep.alpha} != 3")
    if theorem1:
        check(max(rep.workload) <= rep.theoretical_workload_bound,
              f"{name}: max workload above Theorem 1")
    check(rep.capacity_attempts == attempts,
          f"{name}: {rep.capacity_attempts} capacity attempts, want "
          f"{attempts}")


def phase_main(smi: str) -> dict:
    # (keys, expected capacity attempts, Theorem 1 applies).  The Zipf
    # keys take 37 values: Theorem 1 assumes distinct keys, a heavy
    # hitter's bucket receives ~3.7 m here, and its hottest pair (3942
    # keys at seed 0) needs the doubled tile -- one retry.
    inputs = {
        "uniform": (uniform_keys(T * M, seed=SEED).reshape(T, M), 1, True),
        "lidar_like": (lidar_like(T * M, seed=SEED).reshape(T, M), 1, True),
        "zipf": (zipf_keys(T * M, seed=SEED).reshape(T, M), 2, False),
        "adversarial": (adversarial_shards(T, M, 2800, SEED), 2, True),
    }
    out = {}
    for name, (x, attempts, theorem1) in inputs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (keys, _), rep = cluster.sort(x, algorithm="smms", device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(keys.device.type == DEVICE, f"{name}: result not on the card")
        check_run(name, x, keys, rep, attempts, theorem1)
        out[name] = {"first_call_s": wall,
                     "k_workload": rep.k_workload,
                     "k_network": rep.k_network,
                     "max_workload": int(max(rep.workload)),
                     "bound": rep.theoretical_workload_bound,
                     "capacity_attempts": rep.capacity_attempts}
        print(f"[main] t={T} m={M} {name:11s} ok: k_workload="
              f"{rep.k_workload:.4f} k_network={rep.k_network:.4f} "
              f"attempts={rep.capacity_attempts} first call "
              f"{wall * 1e3:.1f} ms ({smi})")
    return out


def phase_small() -> None:
    x = uniform_keys(T_SMALL * M_SMALL, seed=SEED + 1).reshape(T_SMALL,
                                                                M_SMALL)
    (keys, _), rep = cluster.sort(x, algorithm="smms", device=DEVICE)
    (keys_cpu, _), rep_cpu = cluster.sort(x, algorithm="smms", device="cpu")
    check_run("small", x, keys, rep, 1)
    check(same_bits(keys, keys_cpu), "small: card keys != CPU keys")
    check(np.array_equal(rep.boundaries.view(np.int32),
                         rep_cpu.boundaries.view(np.int32)),
          "small: card boundaries != CPU boundaries")
    for field in ("alpha", "k_workload", "k_network", "cap_factor",
                  "capacity_attempts", "exchange_topology",
                  "theoretical_workload_bound"):
        check(getattr(rep, field) == getattr(rep_cpu, field),
              f"small: {field} differs from the CPU run")
    check(np.array_equal(rep.workload, rep_cpu.workload),
          "small: workload differs from the CPU run")
    for a, b in zip(rep.phases, rep_cpu.phases):
        check(a.name == b.name and np.array_equal(a.sent, b.sent)
              and np.array_equal(a.received, b.received),
              f"small: phase {a.name} differs from the CPU run")
    print(f"[small] t={T_SMALL} m={M_SMALL}: keys and every report field "
          f"equal to the CPU run (plain versions), bitwise")


# ---------------------------------------------------------------------------
# 7. times
# ---------------------------------------------------------------------------

def phase_times(rng, smi: str) -> dict:
    dev = torch.device(DEVICE)
    res = {}

    def record(name, ms, plain_ms, library_ms, nbytes, nops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        res[name] = {"ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "bytes": nbytes, "ops": nops}
        print(f"[times] {name:13s} kernel {ms:.4f} ms | plain {plain_ms:.4f} "
              f"ms | library {library_ms:.4f} ms | bound "
              f"{max(bytes_ms, ops_ms):.5f} ms "
              f"({res[name]['bound_by']}) ({smi})")

    # bitonic_sort at (64, 65536) f32: in + out once each; a comparison
    # sort needs log2 m compares per key, not the network's log2(m)^2 / 2
    x = torch.from_numpy(uniform_keys(T * M, seed=SEED).reshape(T, M)).to(dev)
    record("bitonic_sort",
           event_ms(lambda: bitonic.bitonic_sort(x), 20),
           event_ms(lambda: bitonic.bitonic_sort_plain(x), 3, warm=1),
           event_ms(lambda: torch.sort(x, dim=-1), 20),
           2 * x.numel() * 4, x.numel() * int(math.log2(M)))

    # searchsorted: 63 queries into each of 64 sorted rows; a binary
    # search must read only its probes, not the rows
    xs = bitonic.bitonic_sort(x)
    q = xs[:, ::M // T][:, 1:].contiguous()
    steps = math.ceil(math.log2(M + 1))
    probes = T * (T - 1) * steps
    record("searchsorted",
           event_ms(lambda: bucketize.searchsorted(xs, q), 200),
           event_ms(lambda: bucketize.searchsorted_plain(xs, q), 10),
           event_ms(lambda: torch.searchsorted(xs, q, out_int32=True), 200),
           q.numel() * 4 * 2 + probes * 4, probes)

    # merge_rows at the small configuration's receive buffers
    cap = flat_receive_capacity(M_SMALL, T_SMALL, cluster.CapacityPolicy.smms(
        T_SMALL * M_SMALL, T_SMALL, 2).first_factor) // T_SMALL
    # (in + out once each; ceil(log2 t) compares per key merge t rows)
    r = torch.sort(torch.rand((T_SMALL, T_SMALL, cap), device=dev),
                   dim=-1).values
    record("merge_rows",
           event_ms(lambda: bitonic.merge_sorted_rows(r), 200),
           event_ms(lambda: bitonic.merge_sorted_rows_plain(r), 10),
           event_ms(lambda: torch.sort(r.reshape(T_SMALL, -1), dim=-1), 200),
           2 * r.numel() * 4, r.numel() * math.ceil(math.log2(T_SMALL)))

    # merge_ranks at the main path's (64, 64, 4096), bound block 2048:
    # keys and ids in, positions out; merging t sorted rows needs at most
    # ceil(log2 t) compares per key, whatever the kernel's search costs
    kp, ip, recv = _main_rank_operands(rng, dev)
    bb = ops.RANK_MERGE_BOUND_BLOCK
    flat = recv.reshape(T, -1)
    record("merge_ranks",
           event_ms(lambda: fused.merge_ranks(kp, ip, bb), 5, warm=1),
           event_ms(lambda: fused.merge_ranks_plain(kp, ip, bb), 1, warm=0),
           event_ms(lambda: torch.sort(flat, dim=-1), 20),
           (kp.numel() + ip.numel() + kp.numel()) * 4,
           kp.numel() * math.ceil(math.log2(kp.shape[-2])))

    # the end-to-end sort, host clock ending in a synchronize
    xn = uniform_keys(T * M, seed=SEED).reshape(T, M)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cluster.sort(xn, algorithm="smms", device=DEVICE)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    res["sort_e2e"] = {"ms": walls, "median_ms": float(np.median(walls)),
                       "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated()}
    print(f"[times] cluster.sort t={T} m={M} uniform: median "
          f"{np.median(walls):.2f} ms of {len(walls)} (host clock + "
          f"synchronize), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({smi})")
    return res


def main() -> None:
    smi = phase_device()
    build = phase_build()
    rng = np.random.default_rng(SEED)
    errs = phase_kernels(rng)

    cuda.reset_launches()
    main_runs = phase_main(smi)
    phase_small()
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    print(f"[launches] phases 4-5: {launches}")
    for name in KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the main path")

    times = phase_times(rng, smi)
    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                "library_ms": times[name]["library_ms"]}
               for name in KERNELS]
    print(json.dumps({"build": build, "main": main_runs, "times": times}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
