"""Where the time of one port call goes, on the card.

    PYTHONPATH=src python3 -m repro_torch.profile_port \
        [--paths sort,sort_radix,terasort,terasort_radix,randjoin_zipf] \
        [--reps 3]

For each path of :data:`PATHS`: builds the kernels, warms up with two
calls, then runs ``--reps`` calls under ``torch.profiler`` and prints
the host wall time per call, the device time per call summed over every
CUDA kernel and copy, the device's busy share of the wall time, and the
top device consumers by name.  Needs a CUDA device.

The paths are the front doors at the sizes ``chip_smoke.py`` drives:
``sort`` is SMMS on t = 64 x 65,536 uniform float32 keys handed over as
numpy, ``sort_payload`` the same with a (64, 65536, 24) int32 payload
made on the card (100-byte records), ``terasort`` and
``terasort_payload`` the same two by Terasort (its draws made on the
card from the seed), and the joins (:data:`repro_torch.workloads.JOINS`)
run the paper's §5.2 tables at t = 64, host planning and routing
included.  The sort paths run the bitonic kernel family; each has a
``_radix`` twin (``sort_radix``, ``sort_payload_radix``,
``terasort_radix``, ``terasort_payload_radix``) that runs the same call
under ``ops.force_sort_kernel("radix")``.  ``small_sort``,
``small_sort_values`` and ``small_terasort_values`` are the t = 8 x
4,096 sorts (SMMS, SMMS and Terasort with the payload), whose landed
rows take the in-tile merges; ``sort_wide`` and ``terasort_wide`` the
keys-only sorts at t = 64 x 262,144, past the bitonic tile's reach (the
radix sort, the search, the rank merge); ``searchsorted`` is SMMS's Round-3 cut
alone (``ops.searchsorted`` of a (63,) boundary row in (64, 65536)
sorted rows, ``valid_len``); ``round2`` SMMS's Round 2 alone (the
boundaries from the (64, 129) samples); ``merge_rows_kv`` and
``merge_rows_kv_bf16`` the argsort merge alone at SMMS's t = 8 landed
rows, (8, 8, 1077), float32 and bf16 keys; ``radix_sort``,
``radix_sort_bf16``, ``radix_sort_wide`` and ``radix_sort_wide_bf16`` the
radix sort alone at (64, 65536) and (64, 262144); ``pair_sort``,
``pair_sort_partition`` and ``pair_sort_routing`` the pair sorts alone
as ``ops`` calls them (:func:`_pair_call`).  ``serve_prefill`` is
gemma3-12b's prefill of 4 x 2048 tokens and ``serve_decode`` one decode
step after it (:data:`repro_torch.workloads.SERVE_ARCH`), bf16 weights
made on the card from a seed; ``serve_granite_prefill`` and
``serve_granite_decode`` the same on granite-moe-3b-a800m,
``serve_pixtral_prefill`` and ``serve_pixtral_decode`` on pixtral-12b
(256 front-end embeddings of 1024 before each prompt, random, made on
the card), ``serve_mamba2_prefill`` and ``serve_mamba2_decode`` on
mamba2-130m (the SSD scan's chunked prefill and recurrent step); and
``moe_capacity``, ``moe_alpha_k`` and ``moe_cluster`` one granite MoE
layer through ``cluster.moe_dispatch`` (8192 float32 tokens, t = 8);
``train_gemma2b`` and ``train_mamba2`` one training step at full size
(4 x 2048 and 8 x 2048 tokens, remat "full", AdamW).
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import time

import numpy as np
import torch

from repro_torch import cluster
from repro_torch.configs import get_arch
from repro_torch.data import uniform_keys
from repro_torch.kernels import bitonic, cuda, fused, ops, radix
from repro_torch.models import model
from repro_torch.workloads import (JOIN_T, JOINS, M, M_SMALL, M_WIDE,
                                   MOE_ARCH, MOE_T, MOE_TOKENS, SERVE_ARCH,
                                   SERVE_B, SERVE_NEW, SERVE_PROMPT, SSM_ARCH,
                                   T, T_SMALL, TRAIN_ARCH, TRAIN_B,
                                   TRAIN_SEQ, TRAIN_SSM_B, VLM_ARCH,
                                   make_payload)

__all__ = ["PATHS"]


def _sort_call(payload: bool, algorithm: str = "smms",
               family: str = "bitonic", t: int = T, m: int = M):
    x = uniform_keys(t * m, seed=0).reshape(t, m)
    v = make_payload(t, m, 0) if payload else None

    def call():
        with ops.force_sort_kernel(family):
            return cluster.sort(x, algorithm=algorithm, values=v)
    return call


def _merge_call(dtype: torch.dtype):
    """The argsort merge alone at the small configuration's landed rows:
    8 machines x 8 sorted rows of 1,077 slots."""
    rows = torch.sort(torch.rand((T_SMALL, T_SMALL, 1077), device="cuda",
                                 generator=torch.Generator(
                                     "cuda").manual_seed(0)),
                      dim=-1).values.to(dtype)
    return lambda: bitonic.merge_sorted_rows_argsort(rows)


def _search_call():
    """SMMS's Round-3 cut as core/exchange.py makes it: the 63 interior
    boundaries as one (63,) row searched in each of 64 sorted rows of
    65,536 keys, valid_len = 65,536."""
    keys = torch.from_numpy(uniform_keys(T * M, seed=0).reshape(T, M))
    rows = torch.sort(keys.cuda(), dim=-1).values
    bounds = rows[0, ::M // T][1:].contiguous()
    return lambda: ops.searchsorted(rows, bounds, valid_len=M)


def _pair_call(kind: str):
    """A pair sort alone, as ops calls it: ``bitonic_sort_kv`` of (64,
    65536) uniform float32 keys with the order generated (SMMS's Round 1
    with the payload), ``sort_partition_kv`` of the same keys with the
    63 boundaries every machine shares (Terasort's Round 3 with the
    records), or of RandJoin's (64, 2048) int32 draws with 7 (its
    routing)."""
    gen = torch.Generator("cuda").manual_seed(0)
    if kind == "routing":
        keys = torch.randint(0, 8, (T, 2048), dtype=torch.int32,
                             device="cuda", generator=gen)
        bounds = torch.arange(1, 8, dtype=torch.int32, device="cuda")
    else:
        keys = torch.from_numpy(uniform_keys(T * M, seed=0).reshape(T, M))
        keys = keys.cuda()
        bounds = torch.sort(keys[0]).values[M // T::M // T].contiguous()
    if kind == "sort":
        return lambda: bitonic.bitonic_sort_kv(keys)
    return lambda: fused.sort_partition_kv(keys,
                                           ops._query_rows(keys, bounds))


def _radix_call(m: int, dtype: torch.dtype):
    """The radix sort alone (``radix.radix_sort``: the sorted keys and
    the order) of (64, m) uniform keys, float32 or bf16: m = 65,536, the
    bitonic tile's reach, or the wide paths' 262,144."""
    keys = torch.from_numpy(uniform_keys(T * m, seed=0).reshape(T, m))
    keys = keys.cuda().to(dtype)
    return lambda: radix.radix_sort(keys)


def _round2_call():
    """SMMS's Round 2 alone (``core/boundaries.py:boundaries``) on the
    (64, 129) equi-depth samples (s = 2t) of (64, 65536) sorted uniform
    keys: the knots' interpolation and the inverted sum, torch ops."""
    bounds = importlib.import_module("repro_torch.core.boundaries")
    keys = torch.from_numpy(uniform_keys(T * M, seed=0).reshape(T, M))
    lam = bounds.equidepth_samples(torch.sort(keys.cuda(), dim=-1).values,
                                   2 * T)
    return lambda: bounds.boundaries(lam, M, 2 * T)


def _join_call(name: str):
    cfg = JOINS[name]
    s, t = cfg.tables()
    s_rows = np.arange(len(s), dtype=np.int32)
    t_rows = np.arange(len(t), dtype=np.int32)
    return lambda: cluster.join(s, s_rows, t, t_rows,
                                algorithm=cfg.algorithm, t_machines=JOIN_T,
                                **cfg.options)


def _serve_call(kind: str, arch: str = SERVE_ARCH):
    cfg = get_arch(arch)
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)).cuda()
    embeds, front = None, 0
    if cfg.frontend == "vision":
        front = cfg.n_frontend_tokens
        embeds = torch.randn((SERVE_B, front, cfg.frontend_dim),
                             device="cuda", generator=torch.Generator(
                                 device="cuda").manual_seed(1))

    def prefill():
        with torch.inference_mode():
            cache = model.init_cache(cfg, SERVE_B,
                                     front + SERVE_PROMPT + SERVE_NEW,
                                     device="cuda")
            return model.prefill(params, cfg, prompts, cache, embeds)
    if kind == "prefill":
        return lambda: prefill()[0]
    _, cache = prefill()        # room for SERVE_NEW steps: warm-up + reps

    def decode():
        with torch.inference_mode():
            return model.decode_step(params, cfg, prompts[:, :1], cache)[0]
    return decode


def _moe_call(mode: str):
    """``cluster.moe_dispatch`` on one granite-moe-3b-a800m MoE layer:
    bf16 experts, 8192 float32 tokens over t = 8, the plan cached."""
    from repro_torch.models.moe import init_moe
    cfg = get_arch(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_moe(gen, cfg.d_model, cfg.moe, cfg.param_dtype, "cuda")
    x = torch.randn((MOE_TOKENS[MOE_ARCH], cfg.d_model), generator=gen,
                    device="cuda")
    return lambda: cluster.moe_dispatch(params, x, cfg.moe, mode=mode,
                                        t_machines=MOE_T)[0]


def _train_call(arch: str, batch: int):
    """One training step (``launch.steps.build_train_step``, remat
    "full", float32 AdamW moments) of ``arch`` at full size on
    ``batch`` x TRAIN_SEQ tokens of ``data.TokenPipeline``; each call
    updates the same weights."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.optim import adamw_init
    cfg = get_arch(arch)
    bundle = build_train_step(cfg, None, ShapeSpec("p", "train", TRAIN_SEQ,
                                                   batch))
    state = {"params": model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")}
    state["opt"] = adamw_init(state["params"])
    data = batch_on(TokenPipeline(cfg.vocab_size, batch, TRAIN_SEQ)
                    .batch_at(0), "cuda")

    def step():
        state["params"], state["opt"], metrics = bundle.fn(
            state["params"], state["opt"], data)
        return metrics["loss"]
    return step


PATHS = {
    "train_gemma2b": lambda: _train_call(TRAIN_ARCH, TRAIN_B),
    "train_mamba2": lambda: _train_call(SSM_ARCH, TRAIN_SSM_B),
    "serve_prefill": lambda: _serve_call("prefill"),
    "serve_decode": lambda: _serve_call("decode"),
    "serve_granite_prefill": lambda: _serve_call("prefill", MOE_ARCH),
    "serve_granite_decode": lambda: _serve_call("decode", MOE_ARCH),
    **{f"serve_{short}_{kind}": (lambda k=kind, a=arch: _serve_call(k, a))
       for short, arch in (("pixtral", VLM_ARCH), ("mamba2", SSM_ARCH))
       for kind in ("prefill", "decode")},
    **{f"moe_{mode}": (lambda mode=mode: _moe_call(mode))
       for mode in ("capacity", "alpha_k", "cluster")},
    **{name + ("_radix" if family == "radix" else ""):
       (lambda p=payload, a=algorithm, f=family: _sort_call(p, a, f))
       for name, payload, algorithm in (
           ("sort", False, "smms"), ("sort_payload", True, "smms"),
           ("terasort", False, "terasort"),
           ("terasort_payload", True, "terasort"))
       for family in ("bitonic", "radix")},
    **{name: (lambda p=payload, a=algorithm: _sort_call(
        p, a, "bitonic", T_SMALL, M_SMALL))
       for name, payload, algorithm in (
           ("small_sort", False, "smms"), ("small_sort_values", True, "smms"),
           ("small_terasort_values", True, "terasort"))},
    **{name: (lambda a=algorithm: _sort_call(False, a, "radix", T, M_WIDE))
       for name, algorithm in (("sort_wide", "smms"),
                               ("terasort_wide", "terasort"))},
    "searchsorted": _search_call,
    "round2": _round2_call,
    "merge_rows_kv": lambda: _merge_call(torch.float32),
    "pair_sort": lambda: _pair_call("sort"),
    "pair_sort_partition": lambda: _pair_call("partition"),
    "pair_sort_routing": lambda: _pair_call("routing"),
    "merge_rows_kv_bf16": lambda: _merge_call(torch.bfloat16),
    **{"radix_sort" + wide + suffix: (lambda m=m, d=dtype: _radix_call(m, d))
       for wide, m in (("", M), ("_wide", M_WIDE))
       for suffix, dtype in (("", torch.float32), ("_bf16", torch.bfloat16))},
    **{name: (lambda n=name: _join_call(n)) for name in JOINS}}


def profile(name: str, reps: int, top: int, smi: str) -> None:
    call = PATHS[name]()
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    print(f"== {name} on {smi}: {reps} profiled calls: host wall "
          f"{wall_ms:.2f} ms/call, device busy {device_ms:.2f} ms/call "
          f"({100 * device_ms / wall_ms:.1f}% of wall)")
    print(f"{'device ms/call':>14} {'calls/call':>10}  name")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{e.self_device_time_total / 1e3 / reps:14.4f} "
              f"{e.count / reps:10.1f}  {e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="sort",
                    help=f"comma-separated, of {', '.join(PATHS)}")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    names = args.paths.split(",")
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        raise SystemExit(f"profile_port: unknown paths {unknown}; "
                         f"choose from {list(PATHS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cuda.build_all()
    for name in names:
        profile(name, args.reps, args.top, smi)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
