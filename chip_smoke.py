"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's front doors on the card after building the twelve
hand-written CUDA kernels of their paths from seven sources in
``src/repro_torch/csrc`` and holding each against its plain PyTorch
version there:

* ``repro_torch.cluster.sort(x, algorithm="smms")`` -- SMMS with the flat
  static exchange -- and ``algorithm="terasort"`` -- Terasort with
  Algorithm S (paper §3.2), the baseline SMMS is measured against -- at
  t = 64 machines x m = 65,536 float32 keys (n = 4,194,304), keys only
  and with a 96-byte int32 payload per key (a 100-byte record, the sort
  benchmark's record size), and at t = 8 x m = 4,096; each by both sort
  kernel families (the bitonic network and the LSD radix sort,
  ``ops.force_sort_kernel`` where the cost model would pick the other);
  with bf16 keys at both sizes; and at t = 64 x m = 262,144, rows past
  the bitonic tile's reach;
* the same sorts and joins on ``cluster.ProcessGroupSubstrate`` -- the
  t machines over the ranks of a ``torch.distributed`` group: one NCCL
  rank holding all 64, and two Gloo ranks sharing the card;
* the same sorts with ``exchange="staged"`` -- the two-level exchange
  over the 8 x 8 factorization of t = 64 -- and with
  ``algorithm="auto", exchange="auto"`` (the planner's sketch round on
  the card, then the winner), traced once through ``repro_torch.obs``;
* ``repro_torch.cluster.join(...)`` -- StatJoin (paper §4.3) on the
  paper's §5.2 Zipf tables (2^17 x 2^17, theta 0.5) and scalar-skew
  tables (2^20 rows, a hot key 2048 x 2048), RandJoin (§4.2) on the same
  Zipf and scalar-skew tables, repartition on the scalar-skew tables
  and broadcast on Zipf tables of 2^14 x 2^17 rows, all at t = 64;
* ``repro_torch.serve.QueryEngine`` and ``EngineReplicas`` -- the
  query-serving tier: a 64-request trace drawn from ten distinct sorts
  and joins of the sizes above (Zipf-weighted, a 10/30/60 high / normal
  / low class mix) through one engine, four workers fed by four
  threads, and two replicas sharing one pool and one result cache, each
  result bitwise the one-shot call's; and an overload burst of small
  sorts;
* ``repro_torch.kernels.ops.bucketize_histogram`` -- SMMS's Round-3
  planning, 4,194,304 keys into 64 buckets;
* ``repro_torch.serve.generate`` -- greedy generation on gemma3-12b at
  full width and depth (48 layers, bf16, random weights from a seed made
  on the card): 4 prompts of 2048 tokens, 16 new tokens; its prefill
  goes through the flash-attention kernel (bf16: the tensor-core
  kernel), its decode through dense rows; and the same on the MoE
  decoder granite-moe-3b-a800m at full width and depth (32 layers of 40
  experts, top-8, 3.30 G bf16 parameters), every FFN its dense alpha_k
  dispatch;
* ``repro_torch.cluster.moe_dispatch`` -- one MoE layer with its
  token->expert routing run as a skew join -- on a granite layer (8192
  tokens) and a dbrx-132b layer (d 6144, 16 experts of 10752, 2048
  tokens) at full width over t = 8 machines, in the dense ``capacity``
  and ``alpha_k`` modes, the ``cluster`` mode (the routed exchange:
  the owner pair sort and its cut) and ``auto`` (the planner's sketch
  of the routing ids);
* ``repro_torch.serve.generate`` on the rest of the reference's
  configurations: pixtral-12b at full width and depth (40 layers, 256
  front-end embeddings of 1024 before 2048-token prompts) with the bf16
  and the int8 KV cache, mamba2-130m at full width and depth (24 Mamba-2
  layers; also one prompt of 32,768 tokens), and jamba-1.5-large-398b
  at full width cut to one attention and one mamba position (the MoE
  after the mamba one), each with its smoke configuration (and
  gemma-2b's with the int8 cache) against the CPU; the flash kernel
  against the blockwise attention backend at pixtral's prefill shape
  and at gemma3-12b's window; SMMS and Terasort at t = 7, where the
  reference's float32 index arithmetic moves samples (ROADMAP C18),
  against the CPU;
* the model on a mesh: ``build_train_step(cfg, mesh, ...)`` and
  ``serve.generate(..., rules=)`` on ``launch.mesh.make_host_mesh()``
  (one NCCL rank: a (1, 1) mesh), and ``python -m
  repro_torch.launch.dryrun`` on a fake 16 x 16 mesh;
* training (``launch.steps.build_train_step``, ``launch.train.train``):
  gemma-2b at full width and depth (18 layers, 2.51 G parameters, bf16
  weights, float32 AdamW moments, remat "full") on 4 x 2048 tokens a
  step for 8 steps, every attention forward and its recompute through
  the flash kernel (``attention.FlashAttentionFn``, whose backward is
  the blockwise scan under autograd); mamba2-130m at full size on 8 x
  2048 tokens; the four smoke configurations' loss and gradients
  against the CPU; a 30-step ``train`` with a checkpoint and a resume;
  and ``data.smms_length_bucketing`` of 64 x 4,096 document lengths
  through SMMS.  Matmuls run in full float32 where they are float32
  (TF32 off);
* the port's six examples (``examples/torch_*.py``), each ``main()`` as
  a user starts it.

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

  1. device     the card's name and power limit (fails without a card)
  2. build      one nvcc per kernel source, all at once; -Xptxas -v
  3. kernels    each kernel vs its plain version, bitwise (flash
                attention within 1e-5 in f32, rtol 8e-3 + atol 1e-3 in
                bf16), at the main path's shapes and at edge cases (the
                rank merge's merged keys and order also at every landed
                buffer the sort paths hand it, uniform, Zipf and wide,
                against a torch scatter of the plain ranks, and on bf16
                and int32 keys, t = 6 and 48, edge rows; the radix sort
                also at the wide paths' (64, 262144) in f32 and bf16, on
                every class of float, bf16 and int bits at widths 1 to
                262,144 across its 4,096-key tile's edges, and against a
                stable torch.sort of its canonical bits); every
                sort-side kernel again on bf16 keys; flash
                attention also at musicgen-medium's shape; the pair
                sorts at each layout of their one-launch schedule (one
                CTA; clusters of 2, 4 and 8 CTAs; 52,049 unpadded) in
                f32, bf16 and int32 with the order generated and with
                tied values, NaN and sentinel keys; the keys-only sort
                and fused sort on unsorted NaN rows and on rows of +-0
                and denormals only, 3 to 65,536 keys, f32 and bf16, the
                fused sort with a NaN query (ROADMAP C12); the fused
                sort, the pair sort and the searches also at every
                operand the six joins hand them; both in-tile merges at
                the landed rows of the t=8 paths, at t = 3 and 6 with
                odd c, past one block's tile, in f32, bf16 and int32,
                on edge rows with NaN keys; the search with one shared
                query row (and through ops, with and without valid_len)
                on rows and queries with NaN, +-inf and denormals
  4. main path  t=64 x 65,536: uniform, LIDAR-like, Zipf and an
                adversarial placement, keys only and with the payload,
                by SMMS and by Terasort, each by both kernel families;
                keys, payload, workload, alpha, bounds and capacity
                attempts checked on the host, and each radix run equal
                to its bitonic twin; then the six joins, each held
                against a host numpy join
     alpha_k    every t=64 sort above with distinct keys held to its
                theorem's k bound (Theorem 2: 1 + 2/r + r t^3/n = 2.125
                for SMMS, r = 2; Theorem 4: 5 + t^3/n = 5.0625 for
                Terasort), k_workload and k_network; a run above it
                rerun on the CPU, where an equal report is a finding
                and a different one a failure; the StatJoin and RandJoin
                runs on the Zipf and scalar-skew tables: alpha 3 and 1,
                StatJoin's k_out <= 2 (Theorem 6), each k beside
                Theorem 7's / 5's 2 + t/sigma; one JSON line of them all
     lenses     the port's lenses on one SMMS sort at t=64: the traces
                counter equal to the dispatch counts cold and twice them
                after a second call; one sync: span a synchronizing
                operation; every span a profiler range; span()'s cost
                with tracing off
  5. small      t=8 x 4,096 (the in-tile merges) with and without values
                by both sorts and both families, and each join on small
                tables: outputs and every report field equal to the same
                call on the CPU (RandJoin and Terasort on the same draws)
     bf16       bf16 keys: SMMS and Terasort (with the records) at t=64 x
                65,536 equal to np.sort, workload to a host recount; at
                t=8 x 4,096 with values equal to the CPU run
     wide       SMMS and Terasort at t=64 x 262,144: the radix sort and
                the rank merge past the bitonic tile's reach; the first
                call's time and the median of the next three
     NaN keys   t=4 x 64 with four NaN in one row (ROADMAP C13, C14):
                SMMS keys only, SMMS and Terasort with values equal to
                the CPU run: keys, values, report (boundaries but for
                their NaN's bits); the rank merge on NaN rows (C15): the
                replay kernel against its plain version and the CPU run
                at C15's (4, 16500) (blocked) and (64, 1500) (whole
                rows), f32 and bf16, a clean entry beside, at SMMS's
                landed rows with one NaN entry, and the ranks' contract
                with bound_block None and 2048; SMMS (t=2 x 32,768) and
                Terasort (t=2 x 16,384) with values and NaN keys whose
                Round 3 takes the rank merge, equal to the CPU run
     staged     SMMS and Terasort at t=64 x 65,536 with exchange="staged"
                (8 x 8), keys only and with the records, on the four
                inputs: keys, records (in (key, row id) order), workload
                and every report field the topologies share equal to
                the flat run on the card, alpha one more; the medians
                and peaks of both on the uniform keys; the rank merge at
                the staged shapes (phase 3); one traced sort a topology,
                its phase spans equal to the report's phases, and
                obs.timeit against the host clock; t=16 (4 x 4) with
                values equal to the CPU run on the same draws
     multiproc  the process-group substrate (ProcessGroupSubstrate):
                one NCCL rank in this process holding all t = 64
                machines -- SMMS keys only, with the records,
                backend="ragged" and staged 8 x 8, Terasort on injected
                draws, StatJoin and RandJoin on the Zipf tables, the
                small t = 8 sorts -- each bitwise the BatchedSubstrate
                run on the card in every output and report field, its
                median of 3 beside the batch's, every kernel call of one
                ragged run against its plain version; then two Gloo
                ranks sharing the card (32 machines each; this script
                with --gloo-rank): SMMS flat and ragged and StatJoin,
                every rank's whole result equal to its own batch run,
                the collectives staged through pinned host memory; the
                planner and the MoE dispatch on the group (the plan
                cache cleared before every call): algorithm="auto" on
                the t = 64 keys and on the Zipf tables, moe_dispatch in
                its cluster and auto modes on a granite-moe-3b-a800m
                layer of 8,192 tokens at published widths on the NCCL
                rank, and the auto sort on the two Gloo ranks, each
                bitwise its batch run (plan, sketch phases, every
                output and report field), its launches the batch run's
     auto       algorithm="auto" (exchange="auto") on the uniform and
                Zipf t=64 keys, and on the Zipf and scalar-skew join
                tables at t=64: the plan equal to the CPU's (the sketch
                profile bitwise), the output equal to the call naming
                the winner, a second call served from the plan cache
                with no sketch; the planner's cold and cached times
     serve      the query engine at t = 64: ten distinct queries (SMMS and
                Terasort on uniform and Zipf keys, SMMS with the records,
                auto on Zipf keys; StatJoin, RandJoin 8 x 8, auto and
                broadcast on the Zipf tables) one-shot, checked against
                the host; a 64-request trace of them (a) as a loop of
                one-shot calls, (b) through QueryEngine(workers=1), (c)
                workers=4 from 4 submitter threads, (d) EngineReplicas(2)
                sharing pool and result cache: every result bitwise the
                one-shot call's (keys, values, join fields; k_workload,
                k_network, alpha, capacity attempts), executions +
                coalesced + cache hits = 64, each execution's exec_s at
                least half its one-shot wall time; QPS, latency per
                class, cache hits and bytes, peak memory; an overload
                burst of 96 small sorts (t = 8 x 4,096) at 2x the rate
                the engine sustains on them, max_pending=8: no
                high-class request shed or rejected while a lower one is
                queued, every shed typed
  6. serving    bucketize_histogram through its entry point against
                numpy; gemma3-12b's smoke config on the card against the
                CPU (logits within 2e-3, the same tokens); generate at
                full size: tokens, launches (flash_attention once per
                layer), the teacher-forced steps giving generate's
                tokens, and prefill over the prompt and the tokens so far
                against two decode steps' logits (relative L2 <= 5e-2);
                prefill and decode-step times, peak memory
     MoE        granite-moe-3b-a800m's smoke config on the card against
                the CPU; its generate at full size (tokens, flash
                attention once per layer, the teacher-forced steps,
                prefill against every decode step within rel. L2 5e-2
                where neither dropped an assignment; each prefill
                layer's drops and largest slot load); moe_dispatch on
                the granite and dbrx layers: every mode against a dense
                per-token oracle (2e-4), expert counts a host recount,
                capacity and attempts the policy's, auto's plan the
                CPU's, each kernel call held against its plain version;
                at the smoke width every mode's report equal to the
                CPU's; medians of 5 a mode, peak memory
     LM rest    pixtral-12b, mamba2-130m and gemma-2b (int8 cache)
                smoke configs on the card against the CPU (logits within
                2e-3, the same tokens), jamba's too; pixtral-12b at full
                size with the bf16 and the int8 cache (tokens, flash
                attention once per layer, teacher-forced steps, prefill
                against decode within 5e-2, int8 against bf16 within the
                reference's 0.05 / 0.8 bounds, cache bytes), flash
                against the blockwise backend (f32) at its first layer's
                q/k/v and at gemma3's window, where a window one key too
                wide is rejected; mamba2-130m at full size (no kernel
                launched; teacher-forced steps; prefill against decode;
                a 32,768-token prompt; the SSD scan against its float64
                recurrence within 2e-4); the jamba cut (its peak worked
                out first; flash attention once; prefill against decode
                on the steps without drops or routing apart); C18:
                SMMS t = 7 x 1,000 and Terasort t = 7 x 1,024 equal to
                the CPU run (keys, boundaries, workload, report)
     training   FlashAttentionFn at gemma-2b's (4, 8/1, 2048, 256) and
                gemma3-12b's window: dq, dk, dv against autograd through
                the blockwise backend, the forward against the blockwise
                scan (FLASH_TOL), f32 and bf16; the smoke configs of
                gemma-2b, granite, mamba2 and pixtral (with embeds): the
                loss within 1e-5 and every gradient leaf within 1e-3 of
                its largest magnitude of the CPU's; train for 30 steps,
                then 20 and a resume from the step-20 checkpoint (the
                last 10 losses within rtol 1e-5 + atol 1e-6); gemma-2b
                at full size, 8 steps of 4 x 2048 (losses finite and
                falling, the flash kernel twice a step in every layer;
                the median step, tok/s, model_flops over the step time
                over the bf16 peak, the peak memory beside the state
                worked out from the shapes); mamba2-130m the same at 8 x
                2048, 5 steps; SMMS length bucketing of 64 x 4,096
                lengths equal to the CPU run (order, bucket ids, report)
     mesh       the model on a mesh (launch.mesh.make_host_mesh(): a
                (1, 1) ('data', 'model') mesh of one NCCL rank):
                gemma-2b at full size trains 3 steps through
                build_train_step(cfg, mesh, ...) (parameters, moments
                and batches DTensors laid out by sharding/specs.py), its
                losses against train_gemma2b's first three, the step
                time and peak memory; gemma3-12b's generate with the
                rules' cache layout giving serve_gemma3_12b's tokens;
                and launch/dryrun.py, started in the background after
                the build, on gemma-2b train_4k and gemma3-12b
                decode_32k over a fake 16 x 16 mesh of 256 ranks: ok,
                its per-device arguments_bytes equal to the bytes worked
                out from the specs
     examples   each examples/torch_*.py main() on the card at its own
                sizes (torch_sort_cluster as one NCCL rank of a group it
                makes; torch_train_lm also --full: mamba2-130m at its
                published config, 20 steps): keys equal to np.sort and
                reports to the same calls on the CPU, join pairs to a
                host join, losses finite and falling, tokens in range;
                the wall time of each
  7. launches   per path of phases 4-6 (each run's counts set to 0 just
                before it, read just after): each path launched exactly
                the kernels of PATH_KERNELS, and every kernel ran
  8. times      per kernel: CUDA-event time, plain version, one PyTorch
                library call, bound (each sort-side kernel also on bf16
                keys, flash attention also in f32 and at musicgen's,
                pixtral's, the jamba cut's and gemma-2b's training
                shapes, the rank merge
                also at each path's landed
                buffers, the search also as SMMS's Round 3 calls it
                through ops, the pair sorts also as ops calls them,
                the keys-only sort also on rows whose keys fold to zero
                and on rows with NaN keys; the rank merge's NaN
                replay alone at C15's rows and at SMMS's landed rows
                with one NaN entry);
                each sort at (64, 65536) (the keys-only ones also in
                bf16) and the pair sorts at (64, 2048), each in-tile
                merge, the ops search and the bucketize histogram (f32
                and bf16) one C call and one kernel a call (no memset),
                the radix sort one C call, one memset, one
                histogram and one kernel a pass (torch.profiler); the
                radix sort also at (64, 262144), f32 and bf16; the
                bitonic/radix crossover at
                (64, 2^k), k = 10..16, f32, bf16 and int32, with the
                radix-pass cost that fits the cost model to it; the
                end-to-end sorts by both families, StatJoin and
                RandJoin, and peak memory

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels, and the one before that the card's name and power
limit.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import cluster, serve  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch, smoke_config  # noqa: E402
from repro_torch.core import (MASKED_KEY, choose_ab,  # noqa: E402
                              draw_assignments, draw_uniforms,
                              flat_receive_capacity, randjoin_k_bound,
                              report_fields, smms_k_bound, statjoin_k_bound,
                              terasort_k_bound, terasort_sample_count)
from repro_torch.data import (TokenPipeline,  # noqa: E402
                              lidar_like, scalar_skew_tables,
                              smms_length_bucketing, uniform_keys, zipf_keys,
                              zipf_tables)
from repro_torch.kernels import (bitonic, bucketize, cuda, fused,  # noqa: E402
                                 ops, radix)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import attention  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.models.convert import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.launch.train import batch_on, train  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               cosine_schedule)
from repro_torch.workloads import (JOIN_T, JOINS, M, M_SMALL,  # noqa: E402
                                   M_WIDE, MOE_ARCH, MOE_T, MOE_TOKENS,
                                   MOE_WIDE_ARCH, PAYLOAD_COLS, SERVE_ARCH,
                                   SERVE_B, SERVE_NEW, SERVE_PROMPT, T,
                                   T_SMALL, TERASORT_ATTEMPTS, make_payload,
                                   sort_inputs, VLM_ARCH, SSM_ARCH,
                                   SSM_LONG_PROMPT, HYBRID_ARCH, HYBRID_B,
                                   HYBRID_PROMPT, HYBRID_NEW, hybrid_cut,
                                   TRAIN_ARCH, TRAIN_B, TRAIN_SEQ,
                                   TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP,
                                   TRAIN_SSM_B, TRAIN_SSM_STEPS, BUCKETS,
                                   BUCKET_DOCS)

# the module, not the function of the same name repro_torch.core exports
statjoin_mod = importlib.import_module("repro_torch.core.statjoin")

SEED = 0
DEVICE = "cuda"
DETERMINISTIC_JOINS = ("statjoin", "repartition", "broadcast")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 dense tensor cores

# The serving path (SERVE_* in workloads.py): the decode steps whose
# logits a prefill over the prompt and the tokens so far must reproduce,
# and the relative L2 bound on those (B, vocab) logits.  Both paths round
# to bf16 at every layer (the kernel's prefill keeps f32 probabilities,
# the dense-rows decode bf16 ones, and the matmuls of one row and of 2k
# rows sum in other orders), ~2^-9 a rounding, compounded over 48
# residual layers: a few percent, so 5e-2.
SERVE_CHECK_STEPS = (3, 15)
SERVE_REL_L2 = 5e-2
# Planted faults the bound is read against at the first check step: the
# decode steps run with the local layers' window dropped (which the
# bound must reject), and with the window one key too wide (read only:
# one extra key among 1024 is finer than the bound can see; the
# kernel-vs-plain and CPU-vs-reference checks guard the window's edge).
SERVE_FAULTS = {"decode without the window": None,
                "decode with the window off by one": 1025}
# kernel vs plain tolerances (allclose rtol, atol): f32 sums in another
# order over up to 2304 keys x 256 dims; bf16 one ulp where a rounding
# of the f32 result tips (an ulp is at most 2^-7 of the value, so rtol
# 8e-3; atol 1e-3 for values near 0)
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-3)}

# sort algorithm -> the name of its keys-only path (+ "_payload", and
# + "_radix" for the radix family's twin)
PATHS = {"smms": "sort", "terasort": "terasort"}
FAMILIES = ("bitonic", "radix")
# the radix family sorts, then searches (no fused radix+search, as in
# the reference): its t = 64 paths launch the reference's smms_radix /
# terasort_radix budget of a radix sort, a search and a merge
# the rank merge: the merge, then (float keys) the NaN replay, which
# returns at once on entries without a NaN (ROADMAP C15)
RANK_MERGE = {"merge_ranks", "merge_ranks_replay"}
RADIX_MAIN = {"radix_sort", "searchsorted"} | RANK_MERGE
# path -> the kernels one run of it launches, and no others.  A join's
# entry is the bitonic family's set until the kernels phase has seen the
# widths its sorts get (join_kernels): the cost model may pick radix
# for some of them.
LOCAL_JOIN = {"bitonic_sort_kv", "searchsorted"}
# the examples' t = 8 runs: SMMS and Terasort (the in-tile merge), and
# the joins with RandJoin's routing and the auto join's sketch
EXAMPLE_SORTS = {"bitonic_sort", "searchsorted", "merge_rows",
                 "sort_partition"}
EXAMPLE_JOINS = LOCAL_JOIN | {"sort_partition_kv", "bitonic_sort"}
PATH_KERNELS = {
    "sort": {"bitonic_sort", "searchsorted"} | RANK_MERGE,
    "sort_payload": {"bitonic_sort_kv", "searchsorted"} | RANK_MERGE,
    "terasort": {"sort_partition"} | RANK_MERGE,
    "terasort_payload": {"sort_partition_kv"} | RANK_MERGE,
    "sort_radix": RADIX_MAIN,
    "sort_payload_radix": RADIX_MAIN,
    "terasort_radix": RADIX_MAIN,
    "terasort_payload_radix": RADIX_MAIN,
    **{name: LOCAL_JOIN | ({"sort_partition_kv"}
                           if cfg.algorithm == "randjoin" else set())
       for name, cfg in JOINS.items()},
    "small_sort": {"bitonic_sort", "searchsorted", "merge_rows"},
    "small_sort_values": {"bitonic_sort_kv", "searchsorted",
                          "merge_rows_kv"},
    "small_terasort": {"sort_partition", "merge_rows"},
    "small_terasort_values": {"sort_partition_kv", "merge_rows_kv"},
    "small_joins": LOCAL_JOIN,
    "small_randjoin": LOCAL_JOIN | {"sort_partition_kv"},
    "small_sort_radix": {"radix_sort", "searchsorted", "merge_rows"},
    "small_sort_values_radix": {"radix_sort", "searchsorted",
                                "merge_rows_kv"},
    "small_terasort_radix": {"radix_sort", "searchsorted", "merge_rows"},
    "small_terasort_values_radix": {"radix_sort", "searchsorted",
                                    "merge_rows_kv"},
    # bf16 keys at t = 64: the float32 path's set of the family the cost
    # model picks for 16-bit keys there, set by phase_bf16
    "sort_bf16": set(),
    "terasort_payload_bf16": set(),
    "small_sort_values_bf16": {"bitonic_sort_kv", "searchsorted",
                               "merge_rows_kv"},
    "small_terasort_values_bf16": {"sort_partition_kv", "merge_rows_kv"},
    # rows of 2^18, past the bitonic tile's reach
    "sort_wide": RADIX_MAIN,
    "terasort_wide": RADIX_MAIN,
    # the staged exchange at t = 64 (8 x 8): Round 3's cut, then the
    # restage's per-row search; every merge past one tile
    "sort_staged": {"bitonic_sort", "searchsorted"} | RANK_MERGE,
    "sort_staged_payload": {"bitonic_sort_kv", "searchsorted"} | RANK_MERGE,
    "terasort_staged": {"sort_partition", "searchsorted"} | RANK_MERGE,
    "terasort_staged_payload": ({"sort_partition_kv", "searchsorted"}
                                | RANK_MERGE),
    "small_sort_staged_values": {"bitonic_sort_kv", "searchsorted",
                                 "merge_rows_kv"},
    "small_terasort_staged_values": {"sort_partition_kv", "searchsorted",
                                     "merge_rows_kv"},
    # algorithm="auto": the sketch's kernels and the winner's, set by
    # phase_auto from the plan
    "sort_auto_uniform": set(),
    "sort_auto_zipf": set(),
    "join_auto_zipf": set(),
    "join_auto_scalar_skew": set(),
    # the query engine: the kernels the trace's ten distinct queries
    # launch one-shot, set by phase_serve_queries; the overload burst's
    # small SMMS sorts (the cost model's family at 4,096 lanes)
    "serve_queries": set(),
    "serve_overload": set(),
    "bucketize": {"bucketize_histogram"},
    "serve_gemma3_12b": {"flash_attention"},
    "serve_gemma3_smoke": {"flash_attention"},
    # the MoE decoder: flash attention in the prefill; its MoE layers
    # (the dense alpha_k dispatch) run no hand kernel
    "serve_granite": {"flash_attention"},
    "serve_granite_smoke": {"flash_attention"},
    # the rest of the LM stack: flash attention in every attention
    # layer's prefill; the SSD scan, the causal conv and the int8
    # quantization run no hand kernel, so mamba2-130m's paths launch none
    "serve_pixtral": {"flash_attention"},
    "serve_pixtral_int8": {"flash_attention"},
    "serve_mamba2": set(),
    "serve_mamba2_long": set(),
    "serve_jamba": {"flash_attention"},
    "serve_pixtral_smoke": {"flash_attention"},
    "serve_mamba2_smoke": set(),
    "serve_jamba_smoke": {"flash_attention"},
    "serve_gemma2b_int8_smoke": {"flash_attention"},
    # training (remat "full"): the flash kernel in every attention
    # layer's forward and again in its recompute; its backward is the
    # blockwise scan, torch ops.  mamba2-130m's paths launch none.
    # FlashAttentionFn alone at gemma-2b's and gemma3-12b's shapes
    "flash_grad": {"flash_attention"},
    "train_gemma2b_smoke": {"flash_attention"},
    "train_granite_smoke": {"flash_attention"},
    "train_mamba2_smoke": set(),
    "train_pixtral_smoke": {"flash_attention"},
    "train_resume": {"flash_attention"},
    "train_gemma2b": {"flash_attention"},
    "train_mamba2": set(),
    # SMMS length bucketing at 64 x 4,096: Round 1's pair sort of the
    # lengths with their ids, Round 3's search, the in-tile merge of the
    # landed rows with their ids; set by phase_bucketing from the cost
    # model's family
    "bucketing": set(),
    # ROADMAP C18 at t = 7 (the small paths' kernels)
    "c18_smms": {"bitonic_sort", "searchsorted", "merge_rows"},
    "c18_terasort": {"sort_partition", "merge_rows"},
    # cluster.moe_dispatch on one layer at full width, the plan cache
    # cleared: the sketch's sort and self-searches of the (t, m*k) int32
    # routing ids, the owner pair sort and its cut; mode="auto" the
    # sketch, then the winner's (none for a dense mode).  Set by
    # phase_moe_cluster from the cost model's families at those widths
    "moe_cluster_granite_uniform": set(),
    "moe_cluster_granite_hot": set(),
    "moe_auto_granite_uniform": set(),
    "moe_auto_granite_hot": set(),
    "moe_cluster_dbrx_uniform": set(),
    # the process-group substrate (phase_multiproc): on one NCCL rank the
    # batch paths' sets of the same calls, the ragged re-sort's kernel
    # added; on two Gloo ranks (both ranks' launches); set by
    # multiproc_kernels
    **{f"multiproc_{name}": set() for name in (
        "sort", "sort_payload", "sort_ragged", "sort_staged", "terasort",
        "statjoin", "randjoin", "small_sort", "small_sort_values",
        "gloo_sort", "gloo_sort_ragged", "gloo_statjoin")},
    # the planner and the MoE dispatch on the group (the plan cache
    # cleared before every call, so each sketches): the kernels of the
    # batch run of the same call, which phase_multiproc reads; the Gloo
    # ranks' auto sort the one NCCL rank's set
    **{f"multiproc_{name}": set() for name in (
        "sort_auto", "join_auto", "moe_cluster", "moe_auto",
        "gloo_sort_auto")},
    # the model on a mesh (phase_mesh): gemma-2b training and gemma3-12b's
    # generate on a (1, 1) mesh of one NCCL rank, the flash kernel in
    # every attention layer on the rank's local heads
    "mesh_train_gemma2b": {"flash_attention"},
    "mesh_serve_gemma3_12b": {"flash_attention"},
    # the port's examples (phase_examples), each main() at its own
    # sizes: t = 8 sorts of 4,096 - 16,384 keys and joins of 500 rows a
    # machine, all within the bitonic tile, so the cost model's family
    # is bitonic and the landed rows take the in-tile merge; the LLM
    # prefills (gemma-2b's smoke config) the flash kernel; mamba2-130m's
    # training and generation launch none
    "example_quickstart": EXAMPLE_SORTS | EXAMPLE_JOINS,
    "example_sort_cluster": {"bitonic_sort", "searchsorted", "merge_rows"},
    "example_skew_join": EXAMPLE_JOINS,
    "example_serve_requests": (EXAMPLE_SORTS | LOCAL_JOIN
                               | {"bitonic_sort", "flash_attention"}),
    "example_traced_query": {"bitonic_sort", "searchsorted", "merge_rows"},
    "example_train_lm": set(),
    "example_train_lm_full": set(),
}
# path -> kernel -> launches, summed over the path's runs
PATH_LAUNCHES = {path: collections.Counter() for path in PATH_KERNELS}
# (label, algorithm, Theorem 1 / 3 holds, report, the same call on the
# CPU) of every t = 64 sort of phases main and payload, and name ->
# report of the t = 64 joins: what phase alpha_k holds to the k bounds
SORT_REPORTS: list = []
JOIN_REPORTS: dict = {}


def on_path(path: str, fn):
    """One run of ``path``: the launch counts are set to 0 just before
    it and added to the path's counts just after."""
    torch.cuda.synchronize()
    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    PATH_LAUNCHES[path].update(cuda.LAUNCHES)
    return out


def path_name(algorithm: str, payload: bool, family: str) -> str:
    return (PATHS[algorithm] + ("_payload" if payload else "")
            + ("_radix" if family == "radix" else ""))


def cost_model_family(width: int, dtype=torch.float32) -> str:
    """The family the cost model picks on the card for rows of ``width``
    keys of ``dtype``."""
    return ops.sort_kernel_choice(torch.empty((1, width), dtype=dtype,
                                              device=DEVICE))


def forced_family(family: str, width: int) -> Optional[str]:
    """What to force so that rows of ``width`` sort by ``family``: None
    (the cost model) where the model picks it, so a family the model
    picks is driven exactly as a user's call drives it; else
    ``family``."""
    return None if cost_model_family(width) == family else family


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same_bits(x, y) for x, y in zip(a, b))
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if same_bits(a, b):
        return 0.0
    a, b = a.cpu().double(), b.cpu().double()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return math.inf
    return float((a[both] - b[both]).abs().max())


def timed_ms(fn, reps: int, warm: int = 2) -> tuple:
    """(card ms, host ms) of one call: the CUDA-event time of ``reps``
    calls in a row, and the host clock's time to issue them, each over
    ``reps``.  Where the two are close the card waited on the host."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, host * 1e3 / reps


def event_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events."""
    return timed_ms(fn, reps, warm)[0]


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


# The keys-only sorts' widths for the rows they sort on the exact
# comparator and on key-half words: one CTA (3, 1,000) and clusters of 2,
# 4 and 8 CTAs (8,193, 20,000, 65,536) of their one-launch schedule.
KEY_SORT_WIDTHS = (3, 1000, 8193, 20000, 65536)


def _as_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 keys as ``dtype``; bf16 as the top half of each key's bits
    (a NaN keeps its sign and payload, a denormal stays one)."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    return (x.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def _unsorted_nan_rows(rng, rows, n, dtype=torch.float32) -> torch.Tensor:
    """Unsorted gaussian rows with five NaN keys a row at random places, a
    negative NaN and a NaN with a payload among them: the rows the
    network leaves a NaN inside of, where a fused search that sums
    per-tile counts past one 8,192-slot tile missed the reference's cut
    (ROADMAP C12)."""
    x = rng.standard_normal((rows, n)).astype(np.float32)
    for r in range(rows):
        x[r, rng.permutation(n)[:min(n, 5)]] = np.nan
    flat = x.reshape(-1).view(np.uint32)
    nans = np.flatnonzero(np.isnan(x.reshape(-1)))
    flat[nans[::2]] = 0xFFC00000                        # a negative NaN
    flat[nans[1::3]] = 0x7FC00123                       # a payload
    return _as_dtype(torch.from_numpy(x), dtype)


def _zero_class_rows(rng, rows, n, dtype=torch.float32) -> torch.Tensor:
    """Rows of +0, -0 and denormals only: keys that compare equal (C1
    folds them to zero) and differ in bits, so the network alone says
    where each ends up (the key-half words' rows)."""
    tiny = np.float32([0.0, -0.0, 1e-40, -1e-40, 2e-39, -3e-39, 5e-41])
    return _as_dtype(torch.from_numpy(rng.choice(tiny, size=(rows, n))),
                     dtype)


def _queries_with_nan(rng, keys: torch.Tensor) -> torch.Tensor:
    """63 ascending queries drawn from a row's keys, one of them NaN
    (below nothing: its cut is 0), shared by every row."""
    q = keys[0, rng.permutation(keys.shape[1])[:62]]
    q = torch.sort(q[~torch.isnan(q)]).values
    nan = torch.full((1,), float("nan"), dtype=keys.dtype)
    q = torch.cat([q[:len(q) // 2], nan, q[len(q) // 2:]])
    return q[None].expand(keys.shape[0], -1).contiguous()


def _ranked(keys: torch.Tensor):
    """(batch, t, c) sorted rows -> the padded (key, id) rows of _rank_merge."""
    batch, t, c = keys.shape
    kp = bitonic._pad_sorted_rows(keys, math.inf).contiguous()
    tp2, cp2 = kp.shape[-2:]
    ip = bitonic._pad_iota_unique(t, c, tp2, cp2, device=keys.device)
    return kp, ip.expand(batch, tp2, cp2).contiguous()


def comparer(errs: dict):
    """compare(name, label, kernel_out, plain_out): holds a kernel's
    output bitwise against its plain version's, keeping the largest
    error per kernel in ``errs``."""
    def compare(name, label, kernel_out, plain_out):
        ok = same_bits(kernel_out, plain_out)
        err = max_abs_err(kernel_out, plain_out)
        print(f"[kernels] {name:15s} {label:44s} bitwise={ok}")
        check(ok, f"{name} {label}: kernel differs from its plain version "
                  f"(max abs err {err})")
        errs[name] = max(errs.get(name, 0.0), err)
    return compare


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version, both on the card."""
    dev = torch.device(DEVICE)
    errs = {}
    compare = comparer(errs)

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
    # unsorted NaN rows (the exact comparator) and rows of +-0 and
    # denormals only (the key-half words), one CTA to a cluster of 8
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for n in KEY_SORT_WIDTHS:
            for kind, rows in (("unsorted NaN", _unsorted_nan_rows),
                               ("+-0/denormal", _zero_class_rows)):
                e = rows(rng, 4, n, dtype).to(dev)
                compare("bitonic_sort", f"(4, {n}) {dname} {kind} rows",
                        bitonic.bitonic_sort(e), bitonic.bitonic_sort_plain(e))

    # bitonic_sort_kv: the payload sort's (64, 65536) f32 with its iota,
    # a join's int32 T side with a MASKED_KEY tail, and edge rows
    iota = torch.arange(M, dtype=torch.int32, device=dev).repeat(T, 1)
    compare("bitonic_sort_kv", f"({T}, {M}) f32 + iota, the payload sort",
            bitonic.bitonic_sort_kv(x, iota),
            bitonic.bitonic_sort_kv_plain(x, iota))
    tk = torch.from_numpy(rng.integers(1 << 20, 1 << 21, (T, 52049))
                          .astype(np.int32))
    tk[:, 50000:] = MASKED_KEY
    tk = tk.to(dev)
    tiota = torch.arange(52049, dtype=torch.int32, device=dev).repeat(T, 1)
    compare("bitonic_sort_kv", f"({T}, 52049) int32 + iota, MASKED_KEY tail",
            bitonic.bitonic_sort_kv(tk, tiota),
            bitonic.bitonic_sort_kv_plain(tk, tiota))
    for rows, n in [(6, 1000), (4, 65536), (5, 3)]:
        e = _edge_rows(rng, rows, n).to(dev)
        ev = torch.from_numpy(rng.integers(0, 3, (rows, n))
                              .astype(np.int32)).to(dev)
        compare("bitonic_sort_kv", f"({rows}, {n}) edge rows, tied values",
                bitonic.bitonic_sort_kv(e, ev),
                bitonic.bitonic_sort_kv_plain(e, ev))
    mk = torch.from_numpy(rng.integers(-5, 5, (4, 5000)).astype(np.int32))
    mk[:, ::3] = MASKED_KEY
    mk = mk.to(dev)
    mv = torch.arange(5000, dtype=torch.int32, device=dev).repeat(4, 1)
    compare("bitonic_sort_kv", "(4, 5000) int32 ties and MASKED_KEY",
            bitonic.bitonic_sort_kv(mk, mv),
            bitonic.bitonic_sort_kv_plain(mk, mv))

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
    # a join's int32 operands: sorted T rows with a MASKED_KEY tail, S
    # keys that hit, miss and equal MASKED_KEY
    tr = torch.sort(torch.from_numpy(rng.integers(0, 300, (8, 3001))
                                     .astype(np.int32)), dim=1).values
    tr[:, 2500:] = MASKED_KEY
    sq = torch.from_numpy(rng.integers(-5, 305, (8, 2000)).astype(np.int32))
    sq[:, ::9] = MASKED_KEY
    tr, sq = tr.to(dev), sq.to(dev)
    for side in ("left", "right"):
        compare("searchsorted", f"(8, 3001) int32, MASKED_KEY tail, {side}",
                bucketize.searchsorted(tr, sq, side),
                bucketize.searchsorted_plain(tr, sq, side))

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
    compare("merge_rows", "(2, 16, 4096): a cluster at MAX_KERNEL_LANES",
            bitonic.merge_sorted_rows(big),
            bitonic.merge_sorted_rows_plain(big))

    # merge_rows_kv (the argsort merge): the same three shapes
    for label, rows in [(f"({T_SMALL}, {T_SMALL}, {cap}) receive rows", r),
                        ("(1, 8, 300) dups/equal/inf/denormals", e),
                        ("(2, 16, 4096): a cluster at MAX_KERNEL_LANES",
                         big)]:
        compare("merge_rows_kv", label, bitonic.merge_sorted_rows_argsort(rows),
                bitonic.merge_sorted_rows_argsort_plain(rows))
    ei = torch.sort(torch.from_numpy(rng.integers(-3, 3, (2, 8, 777))
                                     .astype(np.int32)), dim=-1).values
    ei[..., -100:] = MASKED_KEY
    ei = ei.to(dev)
    compare("merge_rows_kv", "(2, 8, 777) int32 ties and MASKED_KEY",
            bitonic.merge_sorted_rows_argsort(ei),
            bitonic.merge_sorted_rows_argsort_plain(ei))
    merge_operands(compare, rng, dev)
    search_operands(compare, rng, dev)

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
    rank_operands(compare, rng, dev)
    staged_and_auto_operands(compare)

    def close(name, label, kernel_out, plain_out, tol):
        a, b = kernel_out.float(), plain_out.float()
        rtol, atol = tol
        ok = a.shape == b.shape and bool(torch.allclose(a, b, rtol=rtol,
                                                        atol=atol))
        err = max_abs_err(a, b)
        print(f"[kernels] {name:15s} {label:44s} max abs err {err:.3g} "
              f"(rtol {rtol:g}, atol {atol:g}) ok={ok}")
        check(ok, f"{name} {label}: kernel differs from its plain version "
                  f"(max abs err {err})")
        errs[name] = max(errs.get(name, 0.0), err)

    partition_operands(compare, rng, dev, x)
    pair_sort_operands(compare, rng, dev, x)
    radix_operands(compare, rng, dev, x)
    bucketize_operands(compare, rng, dev, x)
    bf16_operands(compare, rng, dev, x)
    flash_operands(close, dev)
    join_operands(compare)
    torch.cuda.synchronize()
    return errs


def _nan_rows(rng, rows, n) -> torch.Tensor:
    """:func:`_edge_rows` with NaN keys in every fifth row (a NaN at
    every 9th place), sorted as torch sorts them: NaN last."""
    x = _edge_rows(rng, rows, n)
    x[::5, ::9] = math.nan
    return torch.sort(x, dim=-1).values


def merge_operands(compare, rng, dev) -> None:
    """The in-tile merges, keys only and with the order, bitwise against
    their plain versions at every operand the t = 8 paths hand them and
    at the shapes and data those do not reach.

    SMMS (uniform keys, C = 1077 slots a pair) and Terasort (C = 2817)
    run once each at t = 8 x 4,096 with and without values, with the
    two merge wrappers tapped: every call runs the kernel, then the
    plain version on the same card tensors.  On SMMS's landed rows then:
    the same rows as bf16 and as int32 keys, t = 3 and 6 of them with an
    odd c, and the padded entries past one block's shared memory
    ((2, 8, 2817) and (2, 16, 4096), 32,768 and 65,536 slots, up to
    MAX_KERNEL_LANES: a cluster) and past a cluster's ((1, 64, 4096),
    the global passes) in every key dtype; and sorted edge rows (+-inf,
    denormals, +-0, duplicates, an all-equal row, NaN keys) at t = 3, 6
    and 8.  These runs are not main-path runs: the counts are reset
    before each of those.
    """
    merge = bitonic.merge_sorted_rows
    argsort = bitonic.merge_sorted_rows_argsort
    landed = {}

    def tapped(x):
        out = merge(x)
        compare("merge_rows", f"{label}: {tuple(x.shape)} landed rows", out,
                bitonic.merge_sorted_rows_plain(x))
        landed[label] = x
        return out

    def tapped_kv(x):
        out = argsort(x)
        compare("merge_rows_kv", f"{label}: {tuple(x.shape)} landed rows",
                out, bitonic.merge_sorted_rows_argsort_plain(x))
        landed[label] = x
        return out

    x = uniform_keys(T_SMALL * M_SMALL, seed=SEED + 1).reshape(T_SMALL,
                                                                M_SMALL)
    v = np.random.default_rng(SEED).integers(
        0, 1 << 30, (T_SMALL, M_SMALL, 3)).astype(np.int32)
    bitonic.merge_sorted_rows, bitonic.merge_sorted_rows_argsort = (tapped,
                                                                    tapped_kv)
    try:
        for algorithm in PATHS:
            for values in (None, v):
                label = f"small {algorithm}" + ("" if values is None
                                                else " with values")
                cluster.sort(x, algorithm=algorithm, values=values,
                             seed=SEED, device=DEVICE)
    finally:
        bitonic.merge_sorted_rows, bitonic.merge_sorted_rows_argsort = (
            merge, argsort)
    shapes = {tuple(rows.shape) for rows in landed.values()}
    check({(T_SMALL, T_SMALL, 1077), (T_SMALL, T_SMALL, 2817)} <= shapes,
          f"the t = {T_SMALL} paths landed {sorted(shapes)}, not C = 1077 "
          f"(SMMS) and 2817 (Terasort)")

    def both(label, rows):
        compare("merge_rows", label, bitonic.merge_sorted_rows(rows),
                bitonic.merge_sorted_rows_plain(rows))
        compare("merge_rows_kv", label,
                bitonic.merge_sorted_rows_argsort(rows),
                bitonic.merge_sorted_rows_argsort_plain(rows))

    recv = landed["small smms"]
    as_int = torch.where(torch.isinf(recv), torch.iinfo(torch.int32).max,
                         (recv * 7).to(torch.int32))       # ties
    variants = {"bf16": recv.to(torch.bfloat16), "int32 (ties)": as_int,
                "t=3, c=1001": recv[:, :3, :1001].contiguous(),
                "t=6, c=77": recv[:, :6, :77].contiguous()}
    for label, rows in variants.items():
        both(f"small smms {label}: {tuple(rows.shape)}", rows)
    for b, t, c, where in ((2, 8, 2817, "a cluster of 8 CTAs"),
                           (2, 16, 4096, "MAX_KERNEL_LANES, a cluster"),
                           (1, 64, 4096, "past a cluster: global passes")):
        big = torch.sort(torch.from_numpy(rng.standard_normal(
            (b, t, c)).astype(np.float32)), dim=-1).values.to(dev)
        big_i = torch.sort(torch.from_numpy(rng.integers(
            -50, 50, (b, t, c)).astype(np.int32)), dim=-1).values.to(dev)
        for label, rows in (("f32", big), ("bf16", big.to(torch.bfloat16)),
                            ("int32", big_i)):
            both(f"{(b, t, c)} {label}: {where}", rows)
    for t, c in ((3, 301), (6, 1000), (8, 1077)):
        edge = _nan_rows(rng, 2 * t, c).reshape(2, t, c).to(dev)
        both(f"{(2, t, c)} edge rows, NaN keys", edge)
        both(f"{(2, t, c)} bf16 edge rows, NaN keys", edge.to(torch.bfloat16))


def search_operands(compare, rng, dev) -> None:
    """The search with one query row shared by every key row (a (1, q)
    row through ``bucketize.searchsorted``, a (q,) row through
    ``ops.searchsorted``) against its plain version on the same row
    expanded to (B, q), with and without ``valid_len``, at SMMS's
    Round-3 cut ((64, 65536) rows, 63 boundaries) and on rows of
    duplicates, +-inf, denormals and NaN (at the end, as a sort leaves
    them, and inside a row) with NaN, +-inf and denormal queries, in
    float32, bf16 and int32."""
    xs = bitonic.bitonic_sort(torch.from_numpy(
        uniform_keys(T * M, seed=SEED).reshape(T, M)).to(dev))
    row = xs[0, ::M // T][1:].contiguous()
    for side in ("left", "right"):
        for valid_len in (None, M, M // 2):
            want = bucketize.searchsorted_plain(xs, row.expand(T, -1), side,
                                                valid_len)
            compare("searchsorted", f"({T}, {M}) x shared (1, {T - 1}), "
                    f"{side}, valid_len={valid_len}",
                    bucketize.searchsorted(xs, row[None], side, valid_len),
                    want)
            compare("searchsorted", f"ops: ({T}, {M}) x ({T - 1},), {side}, "
                    f"valid_len={valid_len}",
                    ops.searchsorted(xs, row, side=side,
                                     valid_len=valid_len), want)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for b, n, q in ((6, 777, 40), (6, 65536, 63), (8, 3001, 2000),
                        (5, 1, 3)):
            if dtype == torch.int32:
                rows = torch.sort(torch.from_numpy(rng.integers(
                    0, 300, (b, n)).astype(np.int32)), dim=-1).values
                rows[:, n - n // 5:] = MASKED_KEY
                qs = torch.from_numpy(rng.integers(
                    -5, 305, (b, q)).astype(np.int32))
                qs[:, ::9] = MASKED_KEY
            else:
                rows = _nan_rows(rng, b, n)
                rows[-1, n // 2] = math.nan            # NaN inside a row
                qs = torch.from_numpy(rng.standard_normal(
                    (b, q)).astype(np.float32))
                qs[:, ::5] = rows[:, torch.linspace(0, n - 1, qs[:, ::5]
                                                    .shape[1]).long()]
                qs[:, 1::7], qs[:, 2::11], qs[:, 3::11] = (math.nan, math.inf,
                                                           -math.inf)
                qs[:, 4::13] = 1e-40
                rows, qs = rows.to(dtype), qs.to(dtype)
            rows, qs = rows.to(dev), qs.to(dev)
            name = str(dtype)[6:]
            for side in ("left", "right"):
                compare("searchsorted", f"({b}, {n}) x {q} {name} edge rows, "
                        f"{side}", bucketize.searchsorted(rows, qs, side),
                        bucketize.searchsorted_plain(rows, qs, side))
                shared = qs[:1].contiguous()
                compare("searchsorted", f"({b}, {n}) x shared (1, {q}) "
                        f"{name}, {side}, valid_len={n // 2}",
                        bucketize.searchsorted(rows, shared, side, n // 2),
                        bucketize.searchsorted_plain(
                            rows, shared.expand(b, -1), side, n // 2))


def partition_operands(compare, rng, dev, x) -> None:
    """The fused sort-and-partition, keys and pairs, at Terasort's Round 3
    (64, 65536) f32 with 63 boundaries, RandJoin's routing (64, 2048)
    int32 with 7, and edge rows."""
    def both(label, keys, queries):
        compare("sort_partition", label, fused.sort_partition(keys, queries),
                fused.sort_partition_plain(keys, queries))
        compare("sort_partition_kv", label,
                fused.sort_partition_kv(keys, queries),
                fused.sort_partition_kv_plain(keys, queries))

    q = bitonic.bitonic_sort_plain(x)[:, ::M // T][:, 1:]
    both(f"({T}, {M}) f32 x {T - 1} queries, Round 3",
         x, q[:1].expand(T, T - 1).contiguous())
    a = torch.from_numpy(rng.integers(0, 8, (T, 2048)).astype(np.int32))
    both(f"({T}, 2048) int32 x 7 queries, the routing", a.to(dev),
         torch.arange(1, 8, dtype=torch.int32, device=dev)
         .expand(T, 7).contiguous())
    for rows, m in [(4, 7), (4, 100), (4, 8193)]:
        e = _edge_rows(rng, rows, m)
        qe = torch.sort(e[:, rng.permutation(m)[:5]], dim=1).values
        qe[:, -1] = math.inf                              # the sentinel
        qe[3, 0] = 1e-40                                  # a denormal query
        both(f"({rows}, {m}) edge rows, a query = the sentinel", e.to(dev),
             qe.to(dev))
    imax = np.iinfo(np.int32).max
    ei = torch.from_numpy(rng.integers(-3, 3, (4, 8193)).astype(np.int32))
    ei[:, ::5] = imax
    qi = torch.tensor([[-3, 0, 0, 2, imax]], dtype=torch.int32).expand(4, 5)
    both("(4, 8193) int32, INT32_MAX keys and query", ei.to(dev),
         qi.contiguous().to(dev))
    # ROADMAP C12: unsorted NaN rows, whose cuts past one 8,192-slot tile
    # only the reference's own search gives, and rows of +-0 and
    # denormals only; 63 queries, a NaN among them
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for m in KEY_SORT_WIDTHS:
            for kind, rows in (("unsorted NaN", _unsorted_nan_rows),
                               ("+-0/denormal", _zero_class_rows)):
                e = rows(rng, 4, m, dtype)
                both(f"(4, {m}) {dname} {kind} rows x 63, a NaN query",
                     e.to(dev), _queries_with_nan(rng, e).to(dev))


def _pair_rows(rng, rows, m, dtype):
    """Pair-sort operands: keys with heavy ties, +-0, denormals, +-inf,
    NaN and the sort sentinel (int32: INT32_MAX), one gaussian row; int32
    values with ties and int32 max, the pads' value."""
    if dtype == torch.int32:
        k = rng.integers(-3, 3, (rows, m)).astype(np.int32)
        k.reshape(-1)[::5] = np.iinfo(np.int32).max
        keys = torch.from_numpy(k)
    else:
        pool = np.float32([-1.5, 0.0, -0.0, 2.25, 1e-40, -3e-39, np.inf,
                           -np.inf, np.nan, 7.0])
        k = rng.choice(pool, size=(rows, m)).astype(np.float32)
        k[0] = rng.standard_normal(m).astype(np.float32)
        keys = torch.from_numpy(k).to(dtype)
    v = rng.integers(0, 3, (rows, m)).astype(np.int32)
    v.reshape(-1)[::7] = np.iinfo(np.int32).max
    return keys, torch.from_numpy(v)


def pair_sort_operands(compare, rng, dev, x) -> None:
    """The pair sorts' one-launch schedule (csrc/sort_tiles.cuh row_sort)
    at each of its layouts: one CTA (8,192 and 2,048 padded slots) and
    clusters of 2, 4 and 8 CTAs (2^14, 2^15, 2^16; 52,049 unpadded), in
    f32, bf16 and int32, on rows with tied values, +-0, denormals,
    +-inf, NaN and sentinel-valued keys: ``bitonic_sort_kv`` with the
    order generated (``values=None``, what ``ops.sort_kv`` passes) and
    with tied values given, and ``sort_partition_kv`` with 63 queries
    drawn from the row (NaN among them).  Then the main shape (64,
    65536) in each dtype with the order generated."""
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        dname = str(dtype)[6:]
        for m in (2048, 8192, 16384, 32768, 65536, 52049):
            keys, vals = _pair_rows(rng, 4, m, dtype)
            q = torch.sort(keys[:, rng.permutation(m)[:63]], dim=1).values
            keys, vals, q = keys.to(dev), vals.to(dev), q.to(dev)
            compare("bitonic_sort_kv", f"(4, {m}) {dname} edge rows, order "
                    f"generated", bitonic.bitonic_sort_kv(keys),
                    bitonic.bitonic_sort_kv_plain(keys))
            compare("bitonic_sort_kv", f"(4, {m}) {dname} edge rows, tied "
                    f"values", bitonic.bitonic_sort_kv(keys, vals),
                    bitonic.bitonic_sort_kv_plain(keys, vals))
            compare("sort_partition_kv", f"(4, {m}) {dname} edge rows x 63",
                    fused.sort_partition_kv(keys, q),
                    fused.sort_partition_kv_plain(keys, q))
        xm = (x.to(dtype) if dtype != torch.int32 else
              torch.randint(-2**31, 2**31 - 1, x.shape, dtype=torch.int32,
                            device=dev))
        compare("bitonic_sort_kv", f"({T}, {M}) {dname}, order generated",
                bitonic.bitonic_sort_kv(xm), bitonic.bitonic_sort_kv_plain(xm))


# The radix sort's widths: small rows, each edge of its 4,096-key tile
# (csrc/radix_sort.cu kTile), several tiles, the bitonic tile's reach
# and the wide paths' 2^18.
RADIX_WIDTHS = (1, 7, 257, radix.RADIX_TILE - 1, radix.RADIX_TILE,
                radix.RADIX_TILE + 1, 3 * radix.RADIX_TILE + 17, 65535,
                1 << 18)


def _radix_rows(rng, dtype, n: int) -> np.ndarray:
    """One row of each class of bits that breaks radix sorts (the
    classes of tests/test_radix.py's adversarial_keys)."""
    if dtype == np.int32:
        ext = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        ext[rng.integers(0, n, max(1, n // 8))] = np.iinfo(np.int32).min
        ext[rng.integers(0, n, max(1, n // 8))] = np.iinfo(np.int32).max
        return np.stack([
            ext,                                             # extremes
            rng.choice(np.int32([-7, -1, 0, 3]), size=n),    # duplicates
            np.full(n, np.int32(-42)),                       # all equal
            np.sort(rng.integers(-1000, 1000, n).astype(np.int32)),
            np.sort(rng.integers(-1000, 1000, n).astype(np.int32))[::-1],
            (rng.integers(0, 16, n) - 8).astype(np.int32),   # one digit
            rng.integers(-8, 8, n).astype(np.int32) << 28,   # high digit
            rng.integers(-5, 5, n).astype(np.int32)])
    few = max(1, n // 8)
    inf = rng.normal(size=n).astype(np.float32)
    inf[rng.integers(0, n, few)] = np.inf
    inf[rng.integers(0, n, few)] = -np.inf
    nan = rng.normal(size=n).astype(np.float32)
    nan.view(np.uint32)[rng.integers(0, n, few)] = 0x7fc00001    # payloads
    nan.view(np.uint32)[rng.integers(0, n, few)] = 0xffc00123
    nan[rng.integers(0, n, few)] = -0.0
    nan[rng.integers(0, n, few)] = 0.0
    tiny = np.float32([1e-40, -0.0, 0.0, -1e-40, 2e-39, -3e-39, 5e-41, 1.5])
    return np.stack([
        rng.normal(size=n).astype(np.float32),
        rng.choice(np.float32([-1.5, 0.0, 2.25]), size=n),      # duplicates
        np.full(n, np.float32(-3.75)),                          # all equal
        np.sort(rng.normal(size=n)).astype(np.float32),         # presorted
        np.sort(rng.normal(size=n))[::-1].astype(np.float32),   # reversed
        inf, nan,
        tiny[rng.integers(0, len(tiny), n)],                    # denormals
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        .view(np.float32)])                                     # bit soup


def radix_operands(compare, rng, dev, x) -> None:
    """The radix sort at the main path's (64, 65536), float32 and int32,
    at the wide paths' (64, 262144), float32 and bf16, and on every class
    of bits at :data:`RADIX_WIDTHS` (no padding): sorted bits and order
    bitwise against the plain version, and the order against a stable
    torch.sort of the canonical bits."""
    def both(label, keys):
        got = radix.radix_sort(keys)
        compare("radix_sort", label, got, radix.radix_sort_plain(keys))
        canon = radix.sort_ready_bits(keys).long() & 0xFFFFFFFF
        check(torch.equal(got[1].long(),
                          torch.sort(canon, dim=1, stable=True).indices),
              f"radix_sort {label}: order is not the stable argsort of the "
              f"canonical bits")

    both(f"({T}, {M}) f32, the main path", x)
    both(f"({T}, {M}) int32", torch.from_numpy(rng.integers(
        -2**31, 2**31, (T, M), dtype=np.int64).astype(np.int32)).to(dev))
    xw = torch.from_numpy(uniform_keys(T * M_WIDE, seed=SEED + 7)
                          .reshape(T, M_WIDE)).to(dev)
    both(f"({T}, {M_WIDE}) f32, the wide paths", xw)
    both(f"({T}, {M_WIDE}) bf16", xw.to(torch.bfloat16))
    del xw
    for n in RADIX_WIDTHS:
        both(f"(9, {n}) f32: every class of bits",
             torch.from_numpy(_radix_rows(rng, np.float32, n)).to(dev))
        both(f"(8, {n}) int32: every class of bits",
             torch.from_numpy(_radix_rows(rng, np.int32, n)).to(dev))
    print("[kernels] radix_sort      every order above equal to a stable "
          "torch.sort of the canonical bits")


def _bf16_edge_rows(rng, rows, n) -> torch.Tensor:
    """bf16 rows with duplicates, +-0, denormals and +-inf (bf16 keeps
    float32's exponent field, so it has the same classes)."""
    return _edge_rows(rng, rows, n).to(torch.bfloat16)


def bf16_operands(compare, rng, dev, x) -> None:
    """Every sort-side kernel on bf16 keys against its plain version,
    bitwise, at the main path's shapes -- (64, 65536) for the sorts, the
    fused sort and the search with 63 boundaries, (64, 64, 4096) for the
    rank merge, 4,194,304 keys into 64 buckets for the histogram, the
    small configuration's receive rows for the in-tile merges -- and on
    edge rows; the radix sort also on every class of bf16 bits."""
    xb = x.to(torch.bfloat16)
    iota = torch.arange(M, dtype=torch.int32, device=dev).repeat(T, 1)
    compare("bitonic_sort", f"({T}, {M}) bf16, the main shape",
            bitonic.bitonic_sort(xb), bitonic.bitonic_sort_plain(xb))
    compare("bitonic_sort_kv", f"({T}, {M}) bf16 + iota",
            bitonic.bitonic_sort_kv(xb, iota),
            bitonic.bitonic_sort_kv_plain(xb, iota))
    compare("radix_sort", f"({T}, {M}) bf16, 4 passes",
            radix.radix_sort(xb), radix.radix_sort_plain(xb))
    xs = bitonic.bitonic_sort_plain(xb).contiguous()
    q = xs[:1, ::M // T][:, 1:].expand(T, T - 1).contiguous()
    for side in ("left", "right"):
        compare("searchsorted", f"({T}, {M}) bf16 x {T - 1} queries, {side}",
                bucketize.searchsorted(xs, q, side),
                bucketize.searchsorted_plain(xs, q, side))
    compare("sort_partition", f"({T}, {M}) bf16 x {T - 1} queries",
            fused.sort_partition(xb, q), fused.sort_partition_plain(xb, q))
    compare("sort_partition_kv", f"({T}, {M}) bf16 x {T - 1} queries",
            fused.sort_partition_kv(xb, q),
            fused.sort_partition_kv_plain(xb, q))
    keys = xb.reshape(-1)
    bounds = torch.sort(keys).values[M::M].contiguous()
    compare("bucketize_histogram", f"({T * M},) bf16 into {T} buckets",
            bucketize.bucketize_histogram(keys, bounds, T),
            bucketize.bucketize_histogram_plain(keys, bounds, T))
    kp, ip, _ = _main_rank_operands(rng, dev)
    kb = kp.to(torch.bfloat16)
    compare("merge_ranks", f"{tuple(kb.shape)} bf16, bound_block="
            f"{ops.RANK_MERGE_BOUND_BLOCK}",
            fused.merge_ranks(kb, ip, ops.RANK_MERGE_BOUND_BLOCK),
            fused.merge_ranks_plain(kb, ip, ops.RANK_MERGE_BOUND_BLOCK))
    cap = flat_receive_capacity(M_SMALL, T_SMALL,
                                cluster.CapacityPolicy.smms(
                                    T_SMALL * M_SMALL, T_SMALL,
                                    2).first_factor) // T_SMALL
    r = torch.sort(torch.from_numpy(rng.standard_normal(
        (T_SMALL, T_SMALL, cap)).astype(np.float32)).to(dev)
        .to(torch.bfloat16), dim=-1).values
    compare("merge_rows", f"({T_SMALL}, {T_SMALL}, {cap}) bf16 receive rows",
            bitonic.merge_sorted_rows(r), bitonic.merge_sorted_rows_plain(r))
    compare("merge_rows_kv", f"({T_SMALL}, {T_SMALL}, {cap}) bf16",
            bitonic.merge_sorted_rows_argsort(r),
            bitonic.merge_sorted_rows_argsort_plain(r))
    for rows, n in [(6, 1000), (4, 65536), (5, 3)]:
        e = _bf16_edge_rows(rng, rows, n).to(dev)
        ev = torch.arange(n, dtype=torch.int32, device=dev).repeat(rows, 1)
        compare("bitonic_sort", f"({rows}, {n}) bf16 edge rows",
                bitonic.bitonic_sort(e), bitonic.bitonic_sort_plain(e))
        compare("bitonic_sort_kv", f"({rows}, {n}) bf16 edge rows + iota",
                bitonic.bitonic_sort_kv(e, ev),
                bitonic.bitonic_sort_kv_plain(e, ev))
        es = bitonic.bitonic_sort_plain(e).contiguous()
        eq = es[:, ::max(1, n // 5)].contiguous()
        compare("searchsorted", f"({rows}, {n}) bf16 edge rows, queries "
                f"from them", bucketize.searchsorted(es, eq),
                bucketize.searchsorted_plain(es, eq))
        compare("sort_partition_kv", f"({rows}, {n}) bf16 edge rows",
                fused.sort_partition_kv(e, eq),
                fused.sort_partition_kv_plain(e, eq))
    for n in RADIX_WIDTHS:
        rb = torch.from_numpy(_radix_rows(rng, np.float32, n)).to(dev)
        rb = rb.to(torch.bfloat16)     # NaN payloads, +-0, denormals, inf
        compare("radix_sort", f"(9, {n}) bf16: every class of bits",
                radix.radix_sort(rb), radix.radix_sort_plain(rb))
        canon = radix.sort_ready_bits(rb).long()
        check(torch.equal(radix.radix_sort(rb)[1].long(),
                          torch.sort(canon, dim=1, stable=True).indices),
              f"radix_sort (9, {n}) bf16: order is not the stable argsort "
              f"of the canonical bits")


def bucketize_operands(compare, rng, dev, x) -> None:
    """The fused bucketize + histogram, bitwise: at SMMS's shape (its n =
    4,194,304 keys into t = 64 buckets, the keys' own equi-depth
    boundaries), and at edge cases -- t of 1, 2, 6, 10 and 20,000 (past
    the shared-memory histogram), duplicate boundaries, keys equal to
    them, +-inf, NaN, +-0 and denormal keys, int32, and n a multiple of
    no block."""
    keys = x.reshape(-1)
    bounds = torch.sort(keys).values[M::M]            # 63 of them
    compare("bucketize_histogram", f"({T * M},) f32 into {T} buckets, SMMS",
            bucketize.bucketize_histogram(keys, bounds.contiguous(), T),
            bucketize.bucketize_histogram_plain(keys, bounds, T))
    n = 300_001
    e = rng.standard_normal(n).astype(np.float32)
    special = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -1e-40])
    e[::7] = special[rng.integers(0, len(special), len(e[::7]))]
    ei = rng.integers(-50, 50, n).astype(np.int32)
    ei[::13] = np.iinfo(np.int32).max
    for t in (1, 2, 6, 10, 20000):
        for keys_np in (e, ei):
            finite = keys_np[np.isfinite(keys_np.astype(np.float64))]
            b = np.sort(rng.choice(finite, t - 1))
            if t > 3:
                b[1] = b[2]                              # a duplicate
            kt = torch.from_numpy(keys_np).to(dev)
            bt = torch.from_numpy(b.astype(keys_np.dtype)).to(dev)
            compare("bucketize_histogram",
                    f"({n},) {keys_np.dtype} t={t}, dups/inf/NaN/denormals",
                    bucketize.bucketize_histogram(kt, bt, t),
                    bucketize.bucketize_histogram_plain(kt, bt, t))
    bucketize_edges(compare, rng, dev)


def bucketize_edges(compare, rng, dev) -> None:
    """The histogram kernel's own edges, f32, bf16 and int32, every key
    class above: a NaN boundary (f32, bf16); every n from 0 to 33 and
    T * M + 1 (no whole 16-byte
    vector, a tail past the vectors), views at offsets 1 and 3 of a
    T * M + 4 row (a data_ptr off 16 bytes: a scalar head, ids stored
    one by one), and t = 2, 3, 64, 257, 384 (each warp's counters),
    385, 1,025, 4,097 (one block histogram), 12,289 and 20,000 (the
    grid's counters in device memory) at 300,001 keys, in an order that
    goes up and down past SHARED_HIST_MAX on one stream."""
    x = rng.standard_normal(T * M + 4).astype(np.float32)
    special = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40])
    x[::7] = special[rng.integers(0, len(special), len(x[::7]))]
    rows = {torch.float32: torch.from_numpy(x),
            torch.bfloat16: torch.from_numpy(x).to(torch.bfloat16),
            torch.int32: torch.from_numpy(np.nan_to_num(
                x * 100, posinf=2e9, neginf=-2e9).astype(np.int32))}
    for dtype, row in rows.items():
        dname = str(dtype)[6:]
        row = row.to(dev)
        finite = torch.sort(row[torch.isfinite(row.float())]).values

        def bounds(t):
            b = finite[torch.linspace(0, len(finite) - 1, t + 1,
                                      device=dev)[1:-1].long()].clone()
            if t > 3:
                b[1] = b[2]                              # a duplicate
            return b.contiguous()

        b64 = bounds(T)
        for n in [*range(34), T * M + 1]:
            compare("bucketize_histogram", f"({n},) {dname} t={T}",
                    bucketize.bucketize_histogram(row[:n], b64, T),
                    bucketize.bucketize_histogram_plain(row[:n], b64, T))
        if dtype != torch.int32:                 # a NaN boundary
            bn = b64.clone()
            bn[10] = math.nan
            compare("bucketize_histogram", f"({T * M},) {dname} t={T}, a "
                    f"NaN boundary", bucketize.bucketize_histogram(
                        row[:T * M], bn, T),
                    bucketize.bucketize_histogram_plain(row[:T * M], bn, T))
        for off in (1, 3):
            view = row[off:]
            check(view.data_ptr() % 16 != 0, "the view is 16-byte aligned")
            compare("bucketize_histogram",
                    f"({len(view)},) {dname} view at offset {off}",
                    bucketize.bucketize_histogram(view, b64, T),
                    bucketize.bucketize_histogram_plain(view, b64, T))
        # on one stream, so the calls share the kernel's workspace: t
        # past SHARED_HIST_MAX up and down, across the reach of the
        # counters' 128-byte lines (384) and back
        for t in (2, 3, 64, 257, 4097, 12289, 20000, 12289, 20000, 385,
                  384, 1025):
            keys, b = row[:300_001], bounds(t)
            compare("bucketize_histogram", f"(300001,) {dname} t={t}",
                    bucketize.bucketize_histogram(keys, b, t),
                    bucketize.bucketize_histogram_plain(keys, b, t))


def flash_operands(close, dev) -> None:
    """Flash attention against its plain version at gemma3-12b's prefill
    shape (B = 4, 16 q heads over 8 kv heads, S = 2048, head_dim 256),
    global and with its 1024-token window, at musicgen-medium's (MHA, 24
    heads of 64) and at granite-moe-3b-a800m's (GQA, 24 q heads over 8
    kv heads of 64), at pixtral-12b's (4 x 32 q heads over 8 kv heads of
    128, S = 2304: 256 front-end positions and 2048 tokens) and at the
    jamba-1.5-large cut's attention layer (1 x 64 q heads over 8 kv
    heads of 128, S = 1024), at gemma-2b's training step (4 x 8 q heads
    over 1 kv head of 256, S = 2048), in bf16 (the tensor-core kernel) and f32
    (the CUDA-core one); and at edge shapes: S = 17, S a multiple of no
    tile with fewer queries than keys, MQA, and a head_dim (48) that
    the kernel pads."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                                   (b, hkv, sk, d)))

    cfg = get_arch(SERVE_ARCH)
    full = (SERVE_B, cfg.n_heads, cfg.n_kv_heads, SERVE_PROMPT, SERVE_PROMPT,
            cfg.head_dim_)
    mg, gr = get_arch("musicgen-medium"), get_arch(MOE_ARCH)
    px, jb = get_arch(VLM_ARCH), get_arch(HYBRID_ARCH)
    tr = get_arch(TRAIN_ARCH)
    px_s = px.n_frontend_tokens + SERVE_PROMPT
    shapes = [(full, None), (full, cfg.sliding_window),
              ((SERVE_B, mg.n_heads, mg.n_kv_heads, SERVE_PROMPT,
                SERVE_PROMPT, mg.head_dim_), None),
              ((SERVE_B, gr.n_heads, gr.n_kv_heads, SERVE_PROMPT,
                SERVE_PROMPT, gr.head_dim_), None),
              ((SERVE_B, px.n_heads, px.n_kv_heads, px_s, px_s,
                px.head_dim_), None),
              ((HYBRID_B, jb.n_heads, jb.n_kv_heads, HYBRID_PROMPT,
                HYBRID_PROMPT, jb.head_dim_), None),
              ((TRAIN_B, tr.n_heads, tr.n_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
                tr.head_dim_), None),
              ((2, 4, 2, 17, 17, 256), None),
              ((2, 4, 2, 1000, 1300, 128), 333),
              ((1, 8, 1, 777, 777, 64), None),
              ((1, 2, 2, 65, 65, 48), 16)]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, window in shapes:
            q, k, v = qkv(*shape, dtype)
            close("flash_attention",
                  f"{shape} {str(dtype)[6:]} window={window}",
                  fa.flash_attention(q, k, v, True, window),
                  fa.flash_attention_plain(q, k, v, True, window),
                  FLASH_TOL[dtype])
            del q, k, v


def join_kernels(name: str, sorts) -> set:
    """The kernels a join launches: its local join's searches and, for
    each sort it dispatches (op, row width), the kernels of the family
    the cost model picks at that width."""
    want = {"searchsorted"}
    for op, width in sorts:
        radix_family = cost_model_family(width) == "radix"
        if op == "sort_kv":
            want.add("radix_sort" if radix_family else "bitonic_sort_kv")
        else:                       # sort_partition_kv: RandJoin's routing
            want |= ({"radix_sort", "searchsorted"} if radix_family
                     else {"sort_partition_kv"})
    print(f"[kernels] {name}: sorts (op, width) {sorted(set(sorts))} -> "
          f"launches {sorted(want)}")
    return want


# the kernel wrappers a sort path, a join or the planner's sketch hands
# operands: (module, wrapper, kernel name in cuda.KERNELS, plain version)
TAPPED_WRAPPERS = (
    (bitonic, "bitonic_sort", "bitonic_sort", bitonic.bitonic_sort_plain),
    (bitonic, "bitonic_sort_kv", "bitonic_sort_kv",
     bitonic.bitonic_sort_kv_plain),
    (radix, "radix_sort", "radix_sort", radix.radix_sort_plain),
    (bucketize, "searchsorted", "searchsorted", bucketize.searchsorted_plain),
    (fused, "sort_partition", "sort_partition", fused.sort_partition_plain),
    (fused, "sort_partition_kv", "sort_partition_kv",
     fused.sort_partition_kv_plain),
    (bitonic, "merge_sorted_rows", "merge_rows",
     bitonic.merge_sorted_rows_plain),
    (bitonic, "merge_sorted_rows_argsort", "merge_rows_kv",
     bitonic.merge_sorted_rows_argsort_plain),
    (fused, "rank_merge", "merge_ranks", fused.rank_merge_plain),
)


@contextlib.contextmanager
def kernel_taps(compare, label: str, calls: list, keep=None):
    """Every wrapper of :data:`TAPPED_WRAPPERS` tapped while the block
    runs: each call runs the kernel, then its plain version on the same
    card tensors, and the two are held bitwise equal.  ``calls`` gets
    (kernel, operands) of each call; ``keep(kernel, args)`` sees the
    operands.  Runs under taps are not main-path runs: the counts are
    reset before each of those."""
    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _, _ in TAPPED_WRAPPERS]

    def tap(name, kernel, plain):
        def tapped(*args, **kw):
            out = kernel(*args, **kw)
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            what = (" x ".join(str(tuple(a.shape)) for a in ts)
                    + f" {str(ts[0].dtype)[6:]}"
                    + "".join(f", {v}" for v in list(args[len(ts):])
                              + list(kw.values()) if isinstance(v, str)))
            compare(name, f"{label}: {what}", out, plain(*args, **kw))
            calls.append((name, what))
            if keep is not None:
                keep(name, args)
            return out
        return tapped

    for (mod, attr, name, plain), (_, _, kernel) in zip(TAPPED_WRAPPERS,
                                                        saved):
        setattr(mod, attr, tap(name, kernel, plain))
    try:
        yield calls
    finally:
        for mod, attr, kernel in saved:
            setattr(mod, attr, kernel)


def _called(calls, name: str, part: str) -> bool:
    return any(n == name and part in what for n, what in calls)


def join_operands(compare) -> None:
    """The fused pair sort, the pair sort, the radix sort and the
    searches at the joins' own operands.

    Each join of :data:`JOINS` runs once under :func:`kernel_taps`:
    every kernel call is held bitwise against its plain version on the
    same card tensors.  So every shape and dtype the main path's joins
    hand a kernel is checked: RandJoin's int32 draws sorted with their
    order, the int32 T sides with MASKED_KEY tails, the S keys searched
    into them, and the int32 ``cum`` rows searched by every output slot.
    The widths each join's sorts get set its entry of
    :data:`PATH_KERNELS` (:func:`join_kernels`).  These runs are not
    main-path runs: the counts are reset before each of those.
    """
    ops_sort_kv, ops_partition_kv = ops.sort_kv, ops.sort_partition_kv
    for name, cfg in JOINS.items():
        sorts = []

        def tapped_ops_sort_kv(keys, values, **kw):
            sorts.append(("sort_kv", keys.shape[-1]))
            return ops_sort_kv(keys, values, **kw)

        def tapped_ops_partition_kv(keys, values, interior):
            sorts.append(("sort_partition_kv", keys.shape[-1]))
            return ops_partition_kv(keys, values, interior)

        s, t = cfg.tables()
        ops.sort_kv, ops.sort_partition_kv = (tapped_ops_sort_kv,
                                              tapped_ops_partition_kv)
        try:
            with kernel_taps(compare, name, []):
                cluster.join(s, np.arange(len(s), dtype=np.int32),
                             t, np.arange(len(t), dtype=np.int32),
                             algorithm=cfg.algorithm, t_machines=JOIN_T,
                             seed=SEED, device=DEVICE, **cfg.options)
        finally:
            ops.sort_kv, ops.sort_partition_kv = (ops_sort_kv,
                                                  ops_partition_kv)
        PATH_KERNELS[name] = join_kernels(name, sorts)


# landed rows the sort paths hand the rank merge (rank_operands): name ->
# (64, 64, C) rows, for the checks and the times; kept on the host, so
# that the later phases' peak device memory does not count them
RANK_OPERANDS: dict = {}
RANK_RUNS = (("smms", "uniform", M), ("smms", "zipf", M),
             ("terasort", "uniform", M), ("terasort", "zipf", M),
             ("smms", "uniform", M_WIDE), ("terasort", "uniform", M_WIDE))


def rank_operands(compare, rng, dev) -> None:
    """The rank merge at every operand the sort paths hand it, and at the
    dtypes, row counts and edge rows the paths do not reach.

    SMMS and Terasort run once each on the uniform and Zipf (37 values)
    keys at t = 64 x 65,536 and on uniform keys at t = 64 x 262,144 (the
    wide rows) with ``fused.rank_merge`` tapped: every call runs the
    kernel, then the plain version on the same card tensors (the plain
    ranks, then a torch scatter of the keys and the flat ids), and the
    merged keys and order are held bitwise equal.  Each run's last
    landed rows are kept in :data:`RANK_OPERANDS` (on the host).  On SMMS's uniform
    rows then: the same rows as bf16 and as int32 keys, t = 6 and 48 of
    them (not powers of two), and the ranks' contract (``merge_ranks``
    with flat ids); and the sorted edge rows (+-inf, denormals, +-0,
    duplicates, an all-equal row) through both entries.  These runs are
    not main-path runs: the counts are reset before each of those.
    """
    rank_merge = fused.rank_merge
    inputs = sort_inputs(SEED)
    wide = uniform_keys(T * M_WIDE, seed=SEED + 7).reshape(T, M_WIDE)
    for algorithm, name, m in RANK_RUNS:
        label = f"{algorithm}_{name}" + ("_wide" if m == M_WIDE else "")

        def tapped(keys):
            out = rank_merge(keys)
            compare("merge_ranks", f"{label}: {tuple(keys.shape)} "
                    f"{str(keys.dtype)[6:]}, merged keys and order", out,
                    fused.rank_merge_plain(keys))
            RANK_OPERANDS[label] = keys.cpu()
            return out

        fused.rank_merge = tapped
        try:
            cluster.sort(inputs[name][0] if m == M else wide,
                         algorithm=algorithm, seed=SEED, device=DEVICE)
        finally:
            fused.rank_merge = rank_merge
        check(label in RANK_OPERANDS, f"{label}: no rank merge on the path")

    recv = RANK_OPERANDS["smms_uniform"].to(dev)
    finite = torch.where(torch.isinf(recv), 0.0, recv / 1000)  # ties
    as_int = torch.where(torch.isinf(recv), torch.iinfo(torch.int32).max,
                         finite.to(torch.int32))
    variants = {"bf16": recv.to(torch.bfloat16),
                "int32 (ties)": as_int,
                "t=6": recv[:, :6].contiguous(),
                "t=48": recv[:, :48].contiguous(),
                "t=48 bf16": recv[:, :48].to(torch.bfloat16).contiguous()}
    edge = torch.sort(_edge_rows(rng, 12, 5000), dim=-1).values
    variants["edge rows (2, 6, 5000)"] = edge.reshape(2, 6, 5000).to(dev)
    edge = torch.sort(_edge_rows(rng, 8, 300), dim=-1).values[None]
    variants["edge rows (1, 8, 300)"] = edge.to(dev)
    variants["edge rows bf16"] = edge.to(dev).to(torch.bfloat16)
    for label, keys in variants.items():
        compare("merge_ranks", f"{label}: {tuple(keys.shape)}, merged keys "
                f"and order", fused.rank_merge(keys),
                fused.rank_merge_plain(keys))
        batch, t, c = keys.shape
        ids = torch.arange(t * c, dtype=torch.int32, device=dev)
        ids = ids.reshape(1, t, c).expand(batch, t, c).contiguous()
        compare("merge_ranks", f"{label}: {tuple(keys.shape)}, ranks",
                fused.merge_ranks(keys, ids), fused.merge_ranks_plain(keys,
                                                                     ids))


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


# ROADMAP C15's reproduction (padded rows of 32,768 slots: the blocked
# searches) and the widest whole-row case, (64, 1500) in 2,048 slots:
# name -> (seed, t, c, the places of the NaN)
C15_CASES = {
    "C15 (4, 16500), blocked": (1, 4, 16500, ((1, 5), (2, 9000),
                                              (3, 16499))),
    "(64, 1500), whole rows": (3, 64, 1500, ((0, 0), (13, 700), (40, 1499),
                                             (63, 1499), (63, 3)))}


def c15_rows(case: str, dtype=torch.float32) -> torch.Tensor:
    """(2, t, c) rows of :data:`C15_CASES`: ``np.sort`` of normal keys,
    entry 0 clean, entry 1 the same rows with a NaN put at each place,
    as the keys-only network leaves one (a bf16 NaN the quiet 0x7fc0)."""
    seed, t, c, where = C15_CASES[case]
    x = np.sort(np.random.default_rng(seed).standard_normal((t, c))
                .astype(np.float32), axis=1)
    y = x.copy()
    for r, col in where:
        y[r, col] = np.nan
    rows = torch.from_numpy(np.stack([x, y]))
    if dtype == torch.bfloat16:
        rows = rows.to(torch.bfloat16)
        rows.view(torch.int16)[torch.isnan(rows)] = 0x7fc0
    return rows


def smms_nan_rows(dev) -> torch.Tensor:
    """SMMS's landed uniform rows (64, 64, 2152) with NaN in entry 5 at
    the first, a middle and the last real slot of three rows."""
    keys = RANK_OPERANDS["smms_uniform"].clone()
    keys[5, 0, 0] = keys[5, 31, 1000] = keys[5, 63, 2047] = math.nan
    return keys.to(dev)


def replay_operands(compare, dev) -> None:
    """The rank merge on entries whose keys hold a NaN (ROADMAP C15),
    the merge kernel then the replay kernel: at each of
    :data:`C15_CASES` in f32 and bf16, a clean entry beside, the merged
    keys and order against the plain version on the card and against
    the CPU run, bitwise, the call one C call of each; SMMS's landed
    rows with one NaN entry; and the ranks' contract on C15's rows
    padded as the reference pads them, bound_block None and 2048."""
    for case in C15_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            keys = c15_rows(case, dtype)
            kd = keys.to(dev)
            cuda.reset_launches()
            got = fused.rank_merge(kd)
            check(dict(cuda.LAUNCHES) == {"merge_ranks": 1,
                                          "merge_ranks_replay": 1},
                  f"{case}: launched {dict(cuda.LAUNCHES)}")
            label = f"{case} {str(dtype)[6:]}, clean entry beside"
            compare("merge_ranks_replay", label, got,
                    fused.rank_merge_plain(kd))
            check(same_bits(got, fused.rank_merge_plain(keys)),
                  f"{label}: card != the CPU run")
            print(f"[kernels] merge_ranks_replay {label}: equal to the CPU "
                  f"run, bitwise")
    kd = smms_nan_rows(dev)
    compare("merge_ranks_replay", f"SMMS landed {tuple(kd.shape)}, NaN in "
            f"entry 5", fused.rank_merge(kd), fused.rank_merge_plain(kd))
    kp, ip = _ranked(c15_rows("C15 (4, 16500), blocked")[1:].to(dev))
    for bb in (None, ops.RANK_MERGE_BOUND_BLOCK):
        compare("merge_ranks_replay", f"C15 padded {tuple(kp.shape)}, "
                f"ranks, bound_block={bb}", fused.merge_ranks(kp, ip, bb),
                fused.merge_ranks_plain(kp, ip, bb))


# ---------------------------------------------------------------------------
# 4-5. the main path
# ---------------------------------------------------------------------------

def check_run(name: str, x: np.ndarray, keys: torch.Tensor, rep,
              attempts: int, theorem: bool = True) -> None:
    """Keys, workload, alpha, capacity attempts and, where ``theorem``
    (the sort's workload theorem, 1 for SMMS or 3 for Terasort, which
    assume distinct keys) applies, the maximum workload."""
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
    if theorem:
        check(max(rep.workload) <= rep.theoretical_workload_bound,
              f"{name}: max workload above the workload theorem's bound")
    check(rep.capacity_attempts == attempts,
          f"{name}: {rep.capacity_attempts} capacity attempts, want "
          f"{attempts}")


def _expected(algorithm: str, name: str, attempts: int) -> int:
    """The capacity attempts predicted for a sort of input ``name``."""
    return attempts if algorithm == "smms" else TERASORT_ATTEMPTS[name]


def cpu_sort(algorithm: str, name: str, payload_seed=None):
    """The report of phase main's (or, with ``payload_seed``, phase
    payload's) sort of input ``name`` run on the CPU: the same keys,
    records and (Terasort) the card's draws."""
    kw = {}
    if payload_seed is not None:
        kw["values"] = make_payload(T, M, payload_seed, device=DEVICE).cpu()
    if algorithm == "terasort":
        kw["uniforms"] = draw_uniforms(T, M, SEED, DEVICE).cpu()
    return cluster.sort(sort_inputs(SEED)[name][0], algorithm=algorithm,
                        seed=SEED, device="cpu", **kw)[1]


def phase_main(smi: str, algorithm: str, family: str = "bitonic",
               twins: Optional[dict] = None) -> tuple:
    """The sort at t=64 x 65,536 on the four inputs, keys only, by one
    kernel family: keys, workload, alpha, the workload theorem's bound
    (Theorem 1, or 3 for Terasort) where keys are distinct, the
    predicted attempts; with ``twins`` (the other family's outputs),
    keys and every report field equal to them.  Returns (numbers,
    outputs)."""
    out, kept = {}, {}
    path = path_name(algorithm, False, family)
    forced = forced_family(family, M)
    tag = family + ("" if forced is None else " (forced)")
    with ops.force_sort_kernel(forced):
        for name, (x, attempts, theorem) in sort_inputs(SEED).items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (keys, _), rep = on_path(path, lambda: cluster.sort(
                x, algorithm=algorithm, seed=SEED, device=DEVICE))
            wall = time.perf_counter() - t0
            check(keys.device.type == DEVICE,
                  f"{name}: result not on the card")
            label = f"{path} {name}"
            check_run(label, x, keys, rep,
                      _expected(algorithm, name, attempts), theorem)
            SORT_REPORTS.append((label, algorithm, theorem, rep,
                                 functools.partial(cpu_sort, algorithm,
                                                   name)))
            if twins is not None:
                check(same_bits(keys, twins[name][0]),
                      f"{label}: keys differ from the other family's")
                _same_report(label, rep, twins[name][1])
            else:
                kept[name] = (keys, rep)
            out[name] = {"first_call_s": wall,
                         "k_workload": rep.k_workload,
                         "k_network": rep.k_network,
                         "max_workload": int(max(rep.workload)),
                         "bound": rep.theoretical_workload_bound,
                         "capacity_attempts": rep.capacity_attempts}
            print(f"[main] {algorithm} {tag}"
                  f" t={T} m={M} {name:11s} ok: k_workload="
                  f"{rep.k_workload:.4f} k_network={rep.k_network:.4f} max "
                  f"machine {max(rep.workload)} (bound "
                  f"{rep.theoretical_workload_bound:.0f}) attempts="
                  f"{rep.capacity_attempts} first call {wall * 1e3:.1f} ms"
                  f"{'' if twins is None else ', equal to its twin'} "
                  f"({smi})")
    return out, kept


def phase_payload(smi: str, algorithm: str, family: str = "bitonic",
                  twins: Optional[dict] = None) -> tuple:
    """The sort with the 100-byte records, by one kernel family: keys as
    for phase 4, and the payload in the keys' stable order, row for row;
    with ``twins``, keys, records and every report field equal to the
    other family's.  Returns (numbers, outputs)."""
    out, kept = {}, {}
    path = path_name(algorithm, True, family)
    forced = forced_family(family, M)
    tag = family + ("" if forced is None else " (forced)")
    with ops.force_sort_kernel(forced):
        for i, (name, (x, attempts, theorem)) in enumerate(
                sort_inputs(SEED).items()):
            payload = make_payload(T, M, SEED + i, device=DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (keys, vals), rep = on_path(path, lambda: cluster.sort(
                x, algorithm=algorithm, seed=SEED, values=payload,
                device=DEVICE))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            label = f"{path} {name}"
            check_run(label, x, keys, rep,
                      _expected(algorithm, name, attempts), theorem)
            SORT_REPORTS.append((label, algorithm, theorem, rep,
                                 functools.partial(cpu_sort, algorithm, name,
                                                   SEED + i)))
            n = T * M
            check(vals.device.type == DEVICE
                  and vals.shape == (n, PAYLOAD_COLS),
                  f"{label}: values of shape {tuple(vals.shape)}")
            order = np.argsort(x.reshape(-1), kind="stable")
            check(np.array_equal(vals[:, 0].cpu().numpy(), order),
                  f"{label}: column 0 != np.argsort(x, stable)")
            rows = payload.reshape(n, PAYLOAD_COLS)[torch.from_numpy(order)
                                                    .to(DEVICE)]
            check(torch.equal(vals, rows),
                  f"{label}: records differ from the input's rows in stable "
                  f"key order")
            if twins is not None:
                check(same_bits(keys, twins[name][0])
                      and torch.equal(vals.cpu(), twins[name][1]),
                      f"{label}: keys or records differ from the other "
                      f"family's")
                _same_report(label, rep, twins[name][2])
            else:           # the records wait on the host, not in the peak
                kept[name] = (keys, vals.cpu(), rep)
            out[name] = {"first_call_s": wall, "k_workload": rep.k_workload,
                         "k_network": rep.k_network,
                         "capacity_attempts": rep.capacity_attempts,
                         "max_memory_allocated_bytes": peak}
            print(f"[main] {algorithm} {tag}"
                  f" t={T} m={M} payload {name:11s} ok: 100-byte records, "
                  f"k_workload={rep.k_workload:.4f} attempts="
                  f"{rep.capacity_attempts} first call {wall * 1e3:.1f} ms, "
                  f"peak memory {peak / 2**20:.1f} MiB"
                  f"{'' if twins is None else ', equal to its twin'} "
                  f"({smi})")
            del rows, payload
    return out, kept


def phase_bf16(smi: str) -> dict:
    """bf16 keys through the front door (ROADMAP C10).  At t=64 x
    65,536: SMMS keys only and Terasort with the 100-byte records, by
    the family the cost model picks for bf16 there (16-bit keys, 4 radix
    passes), which launches the float32 path's kernels of that family;
    keys equal to np.sort of the input (bf16 values widen to
    float32 exactly), workload equal to a host recount at the report's
    boundaries, alpha 3, the records in the keys' stable order.  At t=8
    x 4,096: SMMS and Terasort with values, keys, values and every
    report field equal to the CPU run (Terasort on the same draws)."""
    out = {}
    xb = torch.from_numpy(uniform_keys(T * M, seed=SEED + 5)
                          .reshape(T, M)).to(torch.bfloat16)
    wide = xb.float().numpy()
    want = np.sort(wide.reshape(-1))
    order = np.argsort(wide.reshape(-1), kind="stable")
    family = cost_model_family(M, xb.dtype)
    for algorithm, with_payload in (("smms", False), ("terasort", True)):
        path = path_name(algorithm, with_payload, "bitonic") + "_bf16"
        PATH_KERNELS[path] = PATH_KERNELS[path_name(algorithm, with_payload,
                                                    family)]
        payload = (make_payload(T, M, SEED + 5, device=DEVICE)
                   if with_payload else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (keys, vals), rep = on_path(path, lambda: cluster.sort(
            xb, algorithm=algorithm, seed=SEED, values=payload,
            device=DEVICE))
        wall = time.perf_counter() - t0
        check(keys.dtype == torch.bfloat16 and keys.device.type == DEVICE,
              f"{path}: keys of {keys.dtype} on {keys.device}")
        check(np.array_equal(keys.float().cpu().numpy(), want),
              f"{path}: keys differ from np.sort of the input")
        cuts = np.searchsorted(want, rep.boundaries[1:-1], side="left")
        recount = np.diff(np.concatenate([[0], cuts, [T * M]]))
        check(np.array_equal(np.asarray(rep.workload), recount),
              f"{path}: workload {rep.workload} != host recount")
        check(rep.alpha == 3, f"{path}: alpha {rep.alpha} != 3")
        if with_payload:
            rows = payload.reshape(T * M, PAYLOAD_COLS)[
                torch.from_numpy(order).to(DEVICE)]
            check(torch.equal(vals, rows),
                  f"{path}: records not in the keys' stable order")
            del rows, payload
        out[path] = {"first_call_s": wall, "k_workload": rep.k_workload,
                     "capacity_attempts": rep.capacity_attempts,
                     "family": family}
        print(f"[bf16] {path}: t={T} m={M} bf16 keys by "
              f"{out[path]['family']} ok: keys = np.sort, workload = host "
              f"recount, k_workload={rep.k_workload:.4f} attempts="
              f"{rep.capacity_attempts} first call {wall * 1e3:.1f} ms "
              f"({smi})")

    xs = torch.from_numpy(zipf_keys(T_SMALL * M_SMALL, seed=SEED + 6)
                          .reshape(T_SMALL, M_SMALL) * 0.37).to(torch.bfloat16)
    u = torch.rand((T_SMALL, M_SMALL),
                   generator=torch.Generator().manual_seed(SEED + 6))
    v = np.random.default_rng(SEED + 6).integers(
        0, 1 << 30, (T_SMALL, M_SMALL, 3)).astype(np.int32)
    for algorithm, kw in (("smms", {}), ("terasort", {"uniforms": u})):
        path = "small_" + PATHS[algorithm] + "_values_bf16"
        (keys, vals), rep = on_path(path, lambda: cluster.sort(
            xs, algorithm=algorithm, values=v, device=DEVICE, **kw))
        (keys_cpu, vals_cpu), rep_cpu = cluster.sort(
            xs, algorithm=algorithm, values=v, device="cpu", **kw)
        check(same_bits(keys, keys_cpu) and same_bits(vals, vals_cpu),
              f"{path}: card keys or values != CPU")
        check(np.array_equal(rep.boundaries, rep_cpu.boundaries),
              f"{path}: card boundaries != CPU boundaries")
        _same_report(path, rep, rep_cpu)
    print(f"[bf16] t={T_SMALL} m={M_SMALL} bf16 Zipf keys with (t, m, 3) "
          f"values, SMMS and Terasort: keys, values, boundaries and every "
          f"report field equal to the CPU run, bitwise")
    return out


def phase_wide(smi: str) -> dict:
    """Rows past the bitonic tile's reach (ROADMAP C10): SMMS and
    Terasort at t=64 x m=262,144 float32 keys (n = 16,777,216), on the
    route the dispatch takes there -- the radix sort, the search, the
    rank merge; keys equal to np.sort, workload to a host recount, the
    workload theorem's bound, one capacity attempt."""
    out = {}
    x = uniform_keys(T * M_WIDE, seed=SEED + 7).reshape(T, M_WIDE)
    check(cost_model_family(M_WIDE) == "radix",
          "the cost model does not pick radix past the bitonic tile")
    for algorithm in PATHS:
        path = PATHS[algorithm] + "_wide"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (keys, _), rep = on_path(path, lambda: cluster.sort(
            x, algorithm=algorithm, seed=SEED, device=DEVICE))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check_run(path, x, keys, rep, 1)
        del keys
        # three more calls, each ending in a synchronize, host clock
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cluster.sort(x, algorithm=algorithm, seed=SEED, device=DEVICE)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        out[path] = {"first_call_s": wall, "next_calls_s": walls,
                     "median_s": float(np.median(walls)),
                     "k_workload": rep.k_workload,
                     "k_network": rep.k_network,
                     "max_workload": int(max(rep.workload)),
                     "bound": rep.theoretical_workload_bound,
                     "max_memory_allocated_bytes": peak}
        print(f"[wide] {algorithm} t={T} m={M_WIDE} ok: k_workload="
              f"{rep.k_workload:.4f} max machine {max(rep.workload)} (bound "
              f"{rep.theoretical_workload_bound:.0f}) first call "
              f"{wall * 1e3:.1f} ms, median of the next 3 "
              f"{np.median(walls) * 1e3:.2f} ms, peak memory "
              f"{peak / 2**20:.1f} MiB ({smi})")
    return out


def _same_nan_run(label: str, out, rep, out_cpu, rep_cpu,
                  values: bool) -> None:
    """A sort of NaN keys on the card against the CPU run: keys, values
    and every report field bitwise, the boundaries but for their NaN's
    bits.  A NaN boundary comes out of Round 2's arithmetic, whose NaN
    bits are the hardware's own (the CPU passes an operand's NaN on, the
    card gives its canonical one): NaN where the CPU has NaN, every
    other boundary bitwise."""
    (keys, vals), (keys_cpu, vals_cpu) = out, out_cpu
    check(keys.device.type == DEVICE and same_bits(keys, keys_cpu),
          f"{label}: card keys != CPU keys")
    if values:
        check(same_bits(vals, vals_cpu), f"{label}: card values != CPU")
    b, b_cpu = np.asarray(rep.boundaries), np.asarray(rep_cpu.boundaries)
    nan = np.isnan(b_cpu)
    check(np.array_equal(np.isnan(b), nan) and np.array_equal(
        b[~nan].view(np.int32), b_cpu[~nan].view(np.int32)),
          f"{label}: card boundaries {b} != CPU boundaries {b_cpu}")
    _same_report(label, rep, rep_cpu)


def phase_nan_keys(errs: dict) -> None:
    """NaN keys through the front door (ROADMAP C13, C14, C15): t=4 x
    m=64 normal keys with four NaN in row 1 -- the keys-only network
    leaves them mid-row, SMMS Round 2 searches knots that hold them, and
    the argsort merge hands a pad's id to the payload gather.  SMMS keys
    only and both sorts with a (t, m) int32 payload (Terasort on the
    same draws): keys, values and every report field equal to the CPU
    run, bitwise, and the boundaries but for the bits of their NaN.
    Then the rank merge on NaN rows (C15): :func:`replay_operands`, and
    SMMS (t=2 x 32,768) and Terasort (t=2 x 16,384) with values and
    three NaN among the keys, whose Round 3 lands rows past one tile
    that hold a NaN, equal to the CPU run the same way."""
    x = np.random.default_rng(SEED).standard_normal((4, 64)).astype(
        np.float32)
    x[1, 5:9] = np.nan
    v = np.arange(x.size, dtype=np.int32).reshape(x.shape) * 7 + 3
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(SEED))
    for algorithm, values in (("smms", None), ("smms", v), ("terasort", v)):
        kw = {"uniforms": u} if algorithm == "terasort" else {}
        out, rep = cluster.sort(x, algorithm=algorithm, values=values,
                                device=DEVICE, **kw)
        out_cpu, rep_cpu = cluster.sort(x, algorithm=algorithm,
                                        values=values, device="cpu", **kw)
        label = f"NaN keys {algorithm}" + (" with values" if values is not None
                                           else "")
        _same_nan_run(label, out, rep, out_cpu, rep_cpu, values is not None)
    print("[small] NaN keys (t=4 x 64, four NaN in one row): SMMS keys only, "
          "SMMS and Terasort with values: keys, values and every report "
          "field equal to the CPU run, bitwise; the boundaries too but for "
          "the bits of their NaN")

    replay_operands(comparer(errs), torch.device(DEVICE))
    merge = fused.rank_merge
    for algorithm, m in (("smms", 32768), ("terasort", 16384)):
        x = np.random.default_rng(SEED).standard_normal((2, m)).astype(
            np.float32)
        x[0, 100] = x[1, 7] = x[1, m - 1] = np.nan
        v = np.arange(x.size, dtype=np.int32).reshape(x.shape)
        kw = ({"uniforms": torch.rand(x.shape, generator=torch.Generator()
                                      .manual_seed(SEED))}
              if algorithm == "terasort" else {})
        landed = []

        def tapped(keys):
            landed.append((tuple(keys.shape), bool(torch.isnan(keys).any())))
            return merge(keys)

        fused.rank_merge = tapped
        try:
            out, rep = cluster.sort(x, algorithm=algorithm, values=v,
                                    device=DEVICE, **kw)
        finally:
            fused.rank_merge = merge
        out_cpu, rep_cpu = cluster.sort(x, algorithm=algorithm, values=v,
                                        device="cpu", **kw)
        label = f"NaN keys {algorithm} t=2 x {m} with values"
        check(len(landed) == 1 and landed[0][1]
              and not ops._merge_fits_one_tile(*landed[0][0][-2:]),
              f"{label}: the rank merge saw {landed}, not NaN rows past "
              f"one tile")
        _same_nan_run(label, out, rep, out_cpu, rep_cpu, True)
        print(f"[small] {label}: landed {landed[0][0]} with NaN (the rank "
              f"merge and its replay); keys, values and every report field "
              f"equal to the CPU run, bitwise (boundaries but for NaN bits)")


def host_pairs(s, t) -> np.ndarray:
    """The equi-join of key columns s and t as row-id pairs, each coded
    s_row << 32 | t_row (int64, unsorted): a plain numpy join."""
    st = np.argsort(t, kind="stable")
    lo = np.searchsorted(t[st], s, side="left")
    cnt = np.searchsorted(t[st], s, side="right") - lo
    si = np.repeat(np.arange(len(s), dtype=np.int64), cnt)
    ti = st[np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
            + np.arange(int(cnt.sum()))]
    return si << 32 | ti


def check_join(name: str, out, rep, want_codes: np.ndarray) -> None:
    w = len(want_codes)
    count = out.count.cpu().numpy()
    check(np.array_equal(count, rep.workload),
          f"{name}: per-machine counts != the report's workload")
    check(np.array_equal(out.valid.sum(1).cpu().numpy(), count),
          f"{name}: valid slots != counts")
    check(int(out.dropped.max()) == 0, f"{name}: results dropped")
    check(int(count.sum()) == w, f"{name}: {int(count.sum())} results, the "
                                 f"host join has {w}")
    got = torch.sort(out.s_rows[out.valid].long() << 32
                     | out.t_rows[out.valid].long()).values
    want = torch.sort(torch.from_numpy(want_codes).to(got.device)).values
    check(torch.equal(got, want),
          f"{name}: (s_row, t_row) pairs differ from the host join")


def phase_joins(smi: str) -> dict:
    out = {}
    for name, cfg in JOINS.items():
        s, t = cfg.tables()
        s_rows = np.arange(len(s), dtype=np.int32)
        t_rows = np.arange(len(t), dtype=np.int32)
        want = host_pairs(s, t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, rep = on_path(name, lambda: cluster.join(
            s, s_rows, t, t_rows, algorithm=cfg.algorithm, t_machines=JOIN_T,
            seed=SEED, device=DEVICE, **cfg.options))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(res.s_rows.device.type == DEVICE,
              f"{name}: result not on the card")
        check_join(name, res, rep, want)
        JOIN_REPORTS[name] = rep
        if cfg.algorithm == "statjoin":
            check(max(rep.workload) <= rep.theoretical_workload_bound,
                  f"{name}: a machine above 2W/t (Theorem 6)")
        out[name] = {"W": len(want), "capacity": int(res.s_rows.shape[1]),
                     "alpha": rep.alpha, "k_workload": rep.k_workload,
                     "k_network": rep.k_network,
                     "max_workload": int(max(rep.workload)),
                     "first_call_s": wall,
                     "max_memory_allocated_bytes": peak}
        if cfg.algorithm == "randjoin":
            check(rep.alpha == 1, f"{name}: alpha {rep.alpha} != 1")
            # StatJoin on the same tables, beside it (not a path run)
            _, st_rep = cluster.join(s, s_rows, t, t_rows,
                                     algorithm="statjoin", t_machines=JOIN_T,
                                     device=DEVICE)
            out[name].update(capacity_attempts=rep.capacity_attempts,
                             statjoin_k_workload=st_rep.k_workload,
                             statjoin_k_network=st_rep.k_network)
            print(f"[main] {name:24s} k_workload {rep.k_workload:.4f} "
                  f"against StatJoin's {st_rep.k_workload:.4f} on the same "
                  f"tables; k_network {rep.k_network:.4f} against "
                  f"{st_rep.k_network:.4f}; {rep.algorithm}, capacity "
                  f"attempts {rep.capacity_attempts}")
        print(f"[main] {name:24s} ok: t={JOIN_T} W={len(want)} slots/machine="
              f"{res.s_rows.shape[1]} alpha={rep.alpha} k_workload="
              f"{rep.k_workload:.4f} max machine {max(rep.workload)} first "
              f"call {wall * 1e3:.1f} ms, peak memory {peak / 2**20:.1f} "
              f"MiB ({smi})")
        del res
    return out


def _same_report(label: str, rep, rep_cpu) -> None:
    for field in ("algorithm", "n_in", "n_out", "alpha", "k_workload",
                  "k_network"):
        check(getattr(rep, field) == getattr(rep_cpu, field),
              f"{label}: {field} differs from the CPU run")
    for field in ("cap_factor", "capacity_attempts",
                  "theoretical_workload_bound"):
        check(getattr(rep, field, None) == getattr(rep_cpu, field, None),
              f"{label}: {field} differs from the CPU run")
    check(np.array_equal(rep.workload, rep_cpu.workload),
          f"{label}: workload differs from the CPU run")
    for a, b in zip(rep.phases, rep_cpu.phases):
        check(a.name == b.name and np.array_equal(a.sent, b.sent)
              and np.array_equal(a.received, b.received),
              f"{label}: phase {a.name} differs from the CPU run")


def phase_small_values_and_joins() -> None:
    x = zipf_keys(T_SMALL * M_SMALL, seed=SEED + 2).reshape(T_SMALL, M_SMALL)
    v = np.random.default_rng(SEED).integers(
        0, 1 << 30, (T_SMALL, M_SMALL, 3)).astype(np.int32)
    with ops.force_sort_kernel(forced_family("bitonic", M_SMALL)):
        (keys, vals), rep = on_path("small_sort_values", lambda: cluster.sort(
            x, algorithm="smms", values=v, device=DEVICE))
    (keys_cpu, vals_cpu), rep_cpu = cluster.sort(x, algorithm="smms",
                                                 values=v, device="cpu")
    check(same_bits(keys, keys_cpu) and same_bits(vals, vals_cpu),
          "small values: card keys or values != CPU")
    _same_report("small values", rep, rep_cpu)
    print(f"[small] t={T_SMALL} m={M_SMALL} with (t, m, 3) values: keys, "
          f"values and every report field equal to the CPU run, bitwise")
    tables = {"zipf": zipf_tables(6000, 5000, theta=0.3, seed=1, domain=50),
              "scalar_skew": scalar_skew_tables(4096, 300, 200, seed=2)}
    for kind, (s, t) in tables.items():
        s_rows = np.arange(len(s), dtype=np.int32)
        t_rows = np.arange(len(t), dtype=np.int32) + 100_000
        for algorithm in DETERMINISTIC_JOINS:
            res, rep = on_path("small_joins", lambda: cluster.join(
                s, s_rows, t, t_rows, algorithm=algorithm,
                t_machines=T_SMALL, device=DEVICE))
            res_cpu, rep_cpu = cluster.join(s, s_rows, t, t_rows,
                                            algorithm=algorithm,
                                            t_machines=T_SMALL, device="cpu")
            label = f"small {algorithm} {kind}"
            for field in res._fields:
                check(same_bits(getattr(res, field), getattr(res_cpu, field)),
                      f"{label}: {field} differs from the CPU run")
            _same_report(label, rep, rep_cpu)
        print(f"[small] t={T_SMALL} {kind} tables: every output and report "
              f"field of {', '.join(DETERMINISTIC_JOINS)} equal to the "
              f"CPU run, bitwise")
        for t_machines in (4, 8):
            a, b = choose_ab(t_machines, len(s), len(t))
            draws = draw_assignments(t_machines, -(-len(s) // t_machines),
                                     -(-len(t) // t_machines), a, b, SEED,
                                     "cpu")
            kw = dict(algorithm="randjoin", t_machines=t_machines,
                      assignments=draws)
            res, rep = on_path("small_randjoin", lambda: cluster.join(
                s, s_rows, t, t_rows, device=DEVICE, **kw))
            res_cpu, rep_cpu = cluster.join(s, s_rows, t, t_rows,
                                            device="cpu", **kw)
            label = f"small randjoin t={t_machines} {kind}"
            for field in res._fields:
                check(same_bits(getattr(res, field), getattr(res_cpu, field)),
                      f"{label}: {field} differs from the CPU run")
            _same_report(label, rep, rep_cpu)
        print(f"[small] RandJoin at t=4 and 8 on the {kind} tables: every "
              f"output and report field equal to the CPU run on the same "
              f"draws, bitwise")


def phase_small_terasort() -> None:
    """Terasort at t=8 x 4,096 (C = 2,817: the in-tile merges), keys
    only and with values: keys, values, boundaries and every report
    field equal to the CPU run on the same draws."""
    x = lidar_like(T_SMALL * M_SMALL, seed=SEED + 3).reshape(T_SMALL,
                                                              M_SMALL)
    u = torch.rand((T_SMALL, M_SMALL),
                   generator=torch.Generator().manual_seed(SEED))
    v = np.random.default_rng(SEED + 3).integers(
        0, 1 << 30, (T_SMALL, M_SMALL, 3)).astype(np.int32)
    for path, values in (("small_terasort", None),
                         ("small_terasort_values", v)):
        with ops.force_sort_kernel(forced_family("bitonic", M_SMALL)):
            (keys, vals), rep = on_path(path, lambda: cluster.sort(
                x, algorithm="terasort", values=values, uniforms=u,
                device=DEVICE))
        (keys_cpu, vals_cpu), rep_cpu = cluster.sort(
            x, algorithm="terasort", values=values, uniforms=u, device="cpu")
        check_run(path, x, keys, rep, 1)
        check(same_bits(keys, keys_cpu), f"{path}: card keys != CPU keys")
        if values is not None:
            check(same_bits(vals, vals_cpu),
                  f"{path}: card values != CPU values")
        check(np.array_equal(rep.boundaries.view(np.int32),
                             rep_cpu.boundaries.view(np.int32)),
              f"{path}: card boundaries != CPU boundaries")
        check(rep.exchange_topology == rep_cpu.exchange_topology,
              f"{path}: exchange_topology differs from the CPU run")
        _same_report(path, rep, rep_cpu)
    print(f"[small] terasort t={T_SMALL} m={M_SMALL} with and without (t, m, "
          f"3) values: keys, values, boundaries and every report field "
          f"equal to the CPU run on the same draws, bitwise")


def phase_small() -> None:
    x = uniform_keys(T_SMALL * M_SMALL, seed=SEED + 1).reshape(T_SMALL,
                                                                M_SMALL)
    with ops.force_sort_kernel(forced_family("bitonic", M_SMALL)):
        (keys, _), rep = on_path("small_sort", lambda: cluster.sort(
            x, algorithm="smms", device=DEVICE))
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


def phase_small_radix() -> None:
    """SMMS and Terasort at t=8 x 4,096 by the radix family, keys only
    and with values: keys, values, boundaries and every report field
    equal to the same call on the CPU under forced radix (Terasort on
    the same draws)."""
    x = zipf_keys(T_SMALL * M_SMALL, seed=SEED + 4).reshape(T_SMALL, M_SMALL)
    u = torch.rand((T_SMALL, M_SMALL),
                   generator=torch.Generator().manual_seed(SEED + 4))
    v = np.random.default_rng(SEED + 4).integers(
        0, 1 << 30, (T_SMALL, M_SMALL, 3)).astype(np.int32)
    forced = forced_family("radix", M_SMALL)
    for algorithm, kw in (("smms", {}), ("terasort", {"uniforms": u})):
        for values in (None, v):
            path = ("small_" + PATHS[algorithm]
                    + ("" if values is None else "_values") + "_radix")
            with ops.force_sort_kernel(forced):
                (keys, vals), rep = on_path(path, lambda: cluster.sort(
                    x, algorithm=algorithm, values=values, device=DEVICE,
                    **kw))
            with ops.force_sort_kernel("radix"):
                (keys_cpu, vals_cpu), rep_cpu = cluster.sort(
                    x, algorithm=algorithm, values=values, device="cpu", **kw)
            check(same_bits(keys, keys_cpu), f"{path}: card keys != CPU keys")
            check(values is None or same_bits(vals, vals_cpu),
                  f"{path}: card values != CPU values")
            check(np.array_equal(rep.boundaries.view(np.int32),
                                 rep_cpu.boundaries.view(np.int32)),
                  f"{path}: card boundaries != CPU boundaries")
            check(rep.exchange_topology == rep_cpu.exchange_topology,
                  f"{path}: exchange_topology differs from the CPU run")
            _same_report(path, rep, rep_cpu)
    print(f"[small] smms and terasort t={T_SMALL} m={M_SMALL} (Zipf keys) by "
          f"the radix family{'' if forced is None else ' (forced)'}, with and "
          f"without (t, m, 3) values: keys, values, boundaries and every "
          f"report field equal to the CPU run under forced radix, bitwise")


# ---------------------------------------------------------------------------
# 6. the histogram's entry point and the serving path
# ---------------------------------------------------------------------------

def phase_bucketize(smi: str) -> dict:
    """The fused bucketize + histogram through its entry point,
    ``ops.bucketize_histogram``, at SMMS's Round-3 planning shape: the
    uniform input's 4,194,304 keys into t = 64 buckets at their
    equi-depth boundaries; ids and counts against numpy on the host."""
    x = uniform_keys(T * M, seed=SEED)
    b = np.sort(x)[M::M]
    keys = torch.from_numpy(x).to(DEVICE)
    bounds = torch.from_numpy(b).to(DEVICE)
    ids, counts = on_path("bucketize", lambda: ops.bucketize_histogram(
        keys, bounds, T))
    want = np.searchsorted(b, x, side="right")
    check(np.array_equal(ids.cpu().numpy(), want),
          "bucketize: ids != np.searchsorted(boundaries, keys, 'right')")
    check(np.array_equal(counts.cpu().numpy(), np.bincount(want, minlength=T)),
          "bucketize: counts != np.bincount of the ids")
    print(f"[main] bucketize_histogram ({T * M},) f32 into {T} buckets: ids "
          f"and counts equal to numpy's; largest bucket "
          f"{int(counts.max())} ({smi})")
    return {"max_count": int(counts.max())}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def lm_params(cfg, label: str) -> tuple:
    """Random bf16 weights for ``cfg`` made on the card from SEED:
    (params, parameter count, parameter bytes, seconds)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    tree_map(lambda w: sizes.append((w.numel(), w.element_size())), params)
    n_params = sum(n for n, _ in sizes)
    n_bytes = sum(n * e for n, e in sizes)
    print(f"[{label}] {cfg.name}: {n_params / 1e9:.3f} G parameters, "
          f"{n_bytes / 1e9:.2f} GB (param_count {cfg.param_count() / 1e9:.3f} "
          f"G), made on the card in {init_s:.1f} s; {cfg.n_layers} layers "
          f"{[cfg.kind(p) for p in range(cfg.period)]} x {cfg.n_periods}, "
          f"d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv "
          f"heads of {cfg.head_dim_ if cfg.n_heads else 0}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}"
          + (f", SSM d_inner {cfg.ssm.d_inner(cfg.d_model)}, "
             f"{cfg.ssm.n_heads(cfg.d_model)} heads of {cfg.ssm.head_dim}, "
             f"d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}"
             if cfg.ssm is not None else "")
          + (f", window {cfg.sliding_window}" if cfg.sliding_window else "")
          + (f", {cfg.moe.num_experts} experts of {cfg.moe.d_ff_expert} "
             f"top-{cfg.moe.top_k}, {cfg.moe.extra_slots} extra slots, "
             f"dispatch {cfg.moe.dispatch} (active "
             f"{cfg.active_param_count() / 1e9:.3f} G)"
             if cfg.moe is not None else "")
          + (f", {cfg.n_frontend_tokens} front-end tokens of "
             f"{cfg.frontend_dim}" if cfg.frontend == "vision" else ""))
    return params, n_params, n_bytes, init_s


def cache_bytes(cfg, batch: int, max_seq: int) -> dict:
    """Bytes of ``init_cache``'s buffers by name (laid out on the meta
    device: nothing allocated)."""
    cache = lm.init_cache(cfg, batch, max_seq, device="meta")
    out = collections.Counter()
    for period in cache["periods"]:
        for layer in period.values():
            for name, buf in layer.items():
                out[name] += buf.numel() * buf.element_size()
    return dict(out)


def served(path: str, params, cfg, prompts: np.ndarray, n_new: int,
           embeds=None, rules=None) -> tuple:
    """``serve.generate`` as one run of ``path`` (on a mesh with
    ``rules``): the tokens (checked for shape, type and range), the
    seconds and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens = on_path(path, lambda: serve.generate(
        params, cfg, prompts, n_new, embeds=embeds, device=DEVICE,
        rules=rules))
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (prompts.shape[0], n_new)
          and tokens.dtype == np.int32 and tokens.min() >= 0
          and tokens.max() < cfg.vocab_size,
          f"{path}: tokens {tokens.shape} {tokens.dtype} out of shape or "
          f"range")
    attn = cfg.n_periods * sum(cfg.kind(p) != "mamba"
                               for p in range(cfg.period))
    launched = PATH_LAUNCHES[path]["flash_attention"]
    check(launched == attn, f"{path}: {launched} flash_attention launches, "
                            f"want one per attention layer ({attn})")
    return tokens, seconds, peak


def phase_serve(smi: str) -> dict:
    """``serve.generate`` for gemma3-12b at full width and depth, bf16,
    B = 4 prompts of 2048 tokens, 16 new tokens: the serving path.

    Checks: the tokens' shape, type and range; the path's launches (the
    flash-attention kernel once per layer of the one prefill, no other
    hand kernel); the same steps teacher-forced (a prefill, then decode
    steps fed generate's tokens) give generate's tokens; and at two
    steps a prefill over the prompt and the tokens so far reproduces
    that decode step's logits within SERVE_REL_L2 -- the kernel's
    prefill against the dense-rows decode at full width, with the same
    reading taken against planted faults (:func:`serve_faults`).  Times:
    the prefill, a decode step, generate end to end; peak memory."""
    cfg = get_arch(SERVE_ARCH)
    params, n_params, _, init_s = lm_params(cfg, "serve")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    tokens, generate_s, peak = served("serve_gemma3_12b", params, cfg,
                                      prompts, SERVE_NEW)

    # the same steps, teacher-forced by generate's tokens, timed
    dev_prompts = torch.from_numpy(prompts).to(DEVICE)
    dev_tokens = torch.from_numpy(tokens).to(DEVICE)
    prefill_ms, step_ms, logits = teacher_forced(params, cfg, dev_prompts,
                                                 dev_tokens, "serve")
    errors, prefilled = prefill_vs_decode(params, cfg, dev_prompts,
                                          dev_tokens, logits, "serve")
    del logits
    with torch.inference_mode():
        faults = serve_faults(params, cfg, prompts, dev_tokens, prefilled)
    decode_ms = float(np.median(step_ms))
    print(f"[serve] generate {SERVE_B} x {SERVE_PROMPT} + {SERVE_NEW}: "
          f"{generate_s:.2f} s first call; prefill {prefill_ms:.1f} ms, a "
          f"decode step {decode_ms:.2f} ms (median of {SERVE_NEW}; host "
          f"clock + synchronize), peak memory {peak / 2**30:.2f} GiB; tokens "
          f"{tokens[:, :6].tolist()} ... ({smi})")
    del params
    torch.cuda.empty_cache()
    return {"parameters": n_params, "init_s": init_s,
            "generate_first_call_s": generate_s, "prefill_ms": prefill_ms,
            "decode_step_ms": step_ms, "decode_step_median_ms": decode_ms,
            "max_memory_allocated_bytes": peak,
            "prefill_vs_decode": errors, "planted_faults": faults,
            "tokens": tokens.tolist()}


def teacher_forced(params, cfg, prompts: torch.Tensor, tokens: torch.Tensor,
                   label: str, embeds: Optional[torch.Tensor] = None,
                   teacher: bool = True) -> tuple:
    """A prefill over ``prompts`` (after ``embeds``, the vision front
    end's), then one decode step per column of ``tokens``, fed those
    tokens; with ``teacher`` (``tokens`` are generate's), each step's
    argmax must be the next token.  Returns the prefill's ms, each
    step's ms (host clock + synchronize) and the logits over the real
    vocabulary, (B, vocab) float32: the prefill's, then each step's."""
    b, n = tokens.shape
    vocab = cfg.vocab_size
    front = embeds.shape[1] if embeds is not None else 0
    with torch.inference_mode():
        cache = lm.init_cache(cfg, b, front + prompts.shape[1] + n,
                              device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, prompts, cache, embeds)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out, step_ms = [logits[:, :vocab].float()], []
        for j in range(n):
            if teacher:
                check(torch.equal(torch.argmax(out[-1], -1),
                                  tokens[:, j].long()),
                      f"{label}: the token after step {j - 1} differs from "
                      f"generate's")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, tokens[:, j:j + 1],
                                           cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits[:, :vocab].float())
        del cache
    return prefill_ms, step_ms, out


def prefill_vs_decode(params, cfg, prompts: torch.Tensor,
                      tokens: torch.Tensor, logits: list, label: str,
                      embeds: Optional[torch.Tensor] = None) -> tuple:
    """At each of SERVE_CHECK_STEPS, a prefill over the prompt and the tokens so
    far reproduces that decode step's logits (``logits[j + 1]``, from
    :func:`teacher_forced`) within SERVE_REL_L2: the kernel's prefill
    against the dense-rows decode (and a mamba layer's chunked scan
    against its recurrent step).  Returns the readings and the
    prefills' logits."""
    errors, prefilled = {}, {}
    b = prompts.shape[0]
    front = embeds.shape[1] if embeds is not None else 0
    with torch.inference_mode():
        for j in SERVE_CHECK_STEPS:
            want = logits[j + 1]
            seq = torch.cat([prompts, tokens[:, :j + 1]], dim=1)
            c = lm.init_cache(cfg, b, front + seq.shape[1], device=DEVICE)
            got, c = lm.prefill(params, cfg, seq, c, embeds)
            del c
            got = got[:, :cfg.vocab_size].float()
            prefilled[j] = got
            err = rel_l2(got, want)
            same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            errors[j] = {"rel_l2": err, "max_abs_err": max_abs_err(got, want),
                         "argmax_agree": same}
            print(f"[{label}] decode step {j} (position "
                  f"{front + prompts.shape[1] + j}): a prefill over "
                  f"{front + seq.shape[1]} positions gives its logits within "
                  f"relative L2 {err:.4g} (bound {SERVE_REL_L2}), max abs "
                  f"err {errors[j]['max_abs_err']:.4g}, argmax agrees on "
                  f"{same:.2f} of the rows")
            check(err <= SERVE_REL_L2,
                  f"{label}: prefill vs decode step {j}: relative L2 {err} > "
                  f"{SERVE_REL_L2}")
    return errors, prefilled


def serve_faults(params, cfg, prompts, dev_tokens, prefilled) -> dict:
    """The prefill-vs-decode check read against planted faults: a prefill
    over the prompt with ``cfg``, then decode steps 0..j teacher-forced
    with the local window changed (SERVE_FAULTS), j the first check
    step; step j's logits against the prefill over the prompt and the
    tokens so far.  Dropping the window must exceed SERVE_REL_L2."""
    j = SERVE_CHECK_STEPS[0]
    readings = {}
    for name, window in SERVE_FAULTS.items():
        faulty = dataclasses.replace(cfg, sliding_window=window)
        cache = lm.init_cache(cfg, SERVE_B, SERVE_PROMPT + j + 1,
                              device=DEVICE)
        _, cache = lm.prefill(params, cfg,
                              torch.from_numpy(prompts).to(DEVICE), cache)
        for i in range(j + 1):
            logits, cache = lm.decode_step(params, faulty,
                                           dev_tokens[:, i:i + 1], cache)
        del cache
        err = rel_l2(prefilled[j], logits[:, :cfg.vocab_size].float())
        readings[name] = err
        print(f"[serve] planted fault, {name} (window {window}): decode step "
              f"{j} against the prefill, relative L2 {err:.4g} (bound "
              f"{SERVE_REL_L2})")
    dropped = readings["decode without the window"]
    check(dropped > SERVE_REL_L2,
          f"serve: the prefill-vs-decode bound {SERVE_REL_L2} does not "
          f"reject a decode without the window ({dropped})")
    return readings


def phase_serve_smoke(arch: str = SERVE_ARCH,
                      path: str = "serve_gemma3_smoke",
                      change: Optional[dict] = None) -> None:
    """``arch``'s smoke configuration with ``change`` (gemma3-12b's: 2
    periods of 6 layers, window 16; granite-moe-3b-a800m's: 2 layers of
    8 experts, top-2; pixtral-12b's with 8 front-end embeddings of 32;
    mamba2-130m's and jamba's Mamba-2 layers, d_state 16, chunk 32;
    gemma-2b's with the int8 cache; float32) on the card against the
    same call on the CPU: the same weights, a 48-token prompt (the
    kernel path, the window, more than a chunk), prefill and decode
    logits within 2e-3 and the same generated tokens."""
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), **(change or {}))
    params = lm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    on_card = tree_map(lambda w: w.to(DEVICE), params)
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    embeds = (torch.from_numpy(rng.standard_normal(
        (2, front, cfg.frontend_dim)).astype(np.float32)) if front else None)
    out = {}
    for device, p in (("cpu", params), (DEVICE, on_card)):
        e = None if embeds is None else embeds.to(device)
        cache = lm.init_cache(cfg, 2, front + 52, device=device)
        run = lambda: lm.prefill(p, cfg, torch.from_numpy(prompts).to(  # noqa: E731
            device), cache, e)
        logits, cache = (on_path(path, run) if device == DEVICE
                         else run())
        step, _ = lm.decode_step(p, cfg, torch.from_numpy(
            prompts[:, :1]).to(device), cache)
        toks = serve.generate(p, cfg, prompts, 4, embeds=e, device=device)
        out[device] = (logits.cpu(), step.cpu(), toks)
    (lc, sc, tc), (lg, sg, tg) = out["cpu"], out[DEVICE]
    check(torch.allclose(lg, lc, rtol=2e-3, atol=2e-3)
          and torch.allclose(sg, sc, rtol=2e-3, atol=2e-3),
          f"{path}: card logits differ from the CPU's beyond 2e-3")
    check(np.array_equal(tg, tc), f"{path}: card tokens != CPU tokens")
    print(f"[small] {cfg.name}{' ' + str(change) if change else ''} on the "
          f"card: prefill and decode logits within "
          f"{max_abs_err(lg, lc):.3g} / {max_abs_err(sg, sc):.3g} of the CPU "
          f"run (bound 2e-3), tokens equal {tg.tolist()}")


# ---------------------------------------------------------------------------
# 6a. MoE: granite-moe-3b-a800m's generate and cluster.moe_dispatch
# ---------------------------------------------------------------------------

# a float32 MoE layer against the dense per-token oracle: the
# reference's own bound (tests/test_moe_cluster.py)
MOE_TOL = (2e-4, 2e-4)
MOE_MODES = ("capacity", "alpha_k", "cluster", "auto")
MOE_SMOKE_D, MOE_SMOKE_TOKENS = 64, 512


@contextlib.contextmanager
def moe_stats_tap(stats: list):
    """Every MoE layer's ``MoEStats`` appended to ``stats`` while the
    block runs (the model calls ``moe.moe_layer`` through its module);
    nothing is read back until the caller reads it."""
    real = moe_mod.moe_layer

    def tapped(*args, **kw):
        y, st = real(*args, **kw)
        stats.append(st)
        return y, st

    moe_mod.moe_layer = tapped
    try:
        yield stats
    finally:
        moe_mod.moe_layer = real


def _dropped(stats) -> int:
    return int(sum(int(st.dropped) for st in stats))


def _last_routes(stats) -> torch.Tensor:
    """(layers, B, k): the experts each layer routed each row's last
    position to, sorted (the set, which decides the layer's output)."""
    return torch.stack([st.ids[:, -1].sort(dim=-1).values
                        for st in stats]).cpu()


def _rows_dropped(stats, last: bool = False) -> torch.Tensor:
    """(B,) bool: the batch rows with an assignment dropped in any layer
    (``MoEStats.keep`` is (B, S, K)); with ``last``, at the row's last
    position only."""
    return torch.stack([~(st.keep[:, -1:] if last else st.keep).reshape(
        st.keep.shape[0], -1).all(dim=1) for st in stats]).any(dim=0).cpu()


def moe_prefill_vs_decode(params, cfg, prompts: torch.Tensor,
                          tokens: torch.Tensor, label: str,
                          teacher: bool, moe_last: bool = False) -> dict:
    """A prefill over the prompts, then decode steps teacher-forced by
    ``tokens`` (with ``teacher``, each step's argmax must be the next
    token), then at every step a prefill over the prompt and the tokens
    so far against that step's logits, within SERVE_REL_L2 on the rows
    where the comparison is one of the attention paths alone: no run
    (the prefill that filled the cache, this prefill, the decode step)
    dropped one of the row's assignments in any layer -- a slot past
    its capacity drops, as in the reference -- and both routed the row's
    last position to the same experts in every layer -- roundings that
    tip a near tie of the k-th and (k+1)-th logits swap an expert, a
    jump the attention paths' agreement does not bound.  ``moe_last``:
    the model's only MoE layer is its last (the jamba cut), so no state
    lies downstream of it: the prefill that filled the cache cannot
    change a step's logits by a drop, and only a drop at the last
    position can.  One step a column of ``tokens``.  Returns the
    readings, the (step, rows) where the bound held, the prefill's
    per-layer drops and loads, and the times."""
    b, n_new = tokens.shape
    vocab = cfg.vocab_size
    cache = lm.init_cache(cfg, b, prompts.shape[1] + n_new, device=DEVICE)
    pre_stats = []
    with moe_stats_tap(pre_stats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    if teacher:
        check(torch.equal(torch.argmax(logits[:, :vocab], -1),
                          tokens[:, 0].long()),
              f"{label}: the prefill's token differs from generate's")
    pre_rows = (torch.zeros(b, dtype=torch.bool) if moe_last
                else _rows_dropped(pre_stats))
    steps = []
    for j in range(n_new):
        stats = []
        with moe_stats_tap(stats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, tokens[:, j:j + 1],
                                           cache)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        steps.append((logits[:, :vocab].float(), _dropped(stats),
                      _rows_dropped(stats), _last_routes(stats), ms))
        if teacher and j + 1 < n_new:
            check(torch.equal(torch.argmax(logits[:, :vocab], -1),
                              tokens[:, j + 1].long()),
                  f"{label}: decode step {j}'s token differs from "
                  f"generate's")
    del cache
    checked, readings = [], {}
    for j, (want, step_drop, step_rows, step_routes, _) in enumerate(steps):
        seq = torch.cat([prompts, tokens[:, :j + 1]], dim=1)
        c = lm.init_cache(cfg, b, seq.shape[1], device=DEVICE)
        stats = []
        with moe_stats_tap(stats):
            got, c = lm.prefill(params, cfg, seq, c)
        del c
        got = got[:, :vocab].float()
        flipped = (_last_routes(stats) != step_routes).any(dim=2).any(dim=0)
        clean = ~(_rows_dropped(stats, moe_last) | step_rows | pre_rows
                  | flipped)
        rows = clean.nonzero().reshape(-1).tolist()
        per_row = [rel_l2(got[r], want[r]) for r in range(b)]
        err_clean = (rel_l2(got[clean.to(DEVICE)], want[clean.to(DEVICE)])
                     if rows else None)
        readings[j] = {"rel_l2": rel_l2(got, want), "rel_l2_by_row": per_row,
                       "rel_l2_clean_rows": err_clean, "clean_rows": rows,
                       "routed_apart_rows": flipped.nonzero().reshape(-1)
                       .tolist(),
                       "decode_dropped": step_drop,
                       "prefill_dropped": _dropped(stats),
                       "argmax_agree": float((got.argmax(-1)
                                              == want.argmax(-1)).float()
                                             .mean())}
        print(f"[moe] {label} decode step {j}: a prefill over {seq.shape[1]} "
              f"tokens gives its logits within relative L2 "
              f"{[float(f'{e:.4g}') for e in per_row]} by row; rows routed "
              f"apart "
              f"{readings[j]['routed_apart_rows']}; dropped: decode "
              f"{step_drop}, prefill {readings[j]['prefill_dropped']}; "
              + (f"{err_clean:.4g} on the clean rows {rows} (bound "
                 f"{SERVE_REL_L2})" if rows else "no clean row"))
        if rows:
            checked.append((j, rows))
            check(err_clean <= SERVE_REL_L2,
                  f"{label}: prefill vs decode step {j}, rows {rows}: "
                  f"relative L2 {err_clean} > {SERVE_REL_L2}")
    print(f"[moe] {label}: the prefill-vs-decode bound held on "
          f"{sum(len(r) for _, r in checked)} of {n_new * b} (step, row) "
          f"pairs, at {len(checked)} of {n_new} steps; rows with drops "
          f"in the prefill that filled the cache "
          f"{pre_rows.nonzero().reshape(-1).tolist()}")
    return {"prefill_ms": prefill_ms,
            "prefill_dropped_by_layer": [int(st.dropped) for st in pre_stats],
            "prefill_max_slot_load_by_layer": [int(st.max_slot_load)
                                               for st in pre_stats],
            "decode_step_ms": [st[-1] for st in steps],
            "decode_dropped_by_step": [st[1] for st in steps],
            "prefill_vs_decode": readings, "checked": checked}


def phase_serve_granite(smi: str) -> dict:
    """``serve.generate`` for granite-moe-3b-a800m at full width and
    depth, bf16, B = 4 prompts of 2048 tokens, 16 new tokens: the MoE
    serving path (every layer's FFN the dense alpha_k dispatch).

    Checks: the tokens' shape, type and range; flash attention once per
    layer; the teacher-forced prefill and decode steps give generate's
    tokens; prefill against decode (:func:`moe_prefill_vs_decode`)
    within SERVE_REL_L2 on the rows without drops or routing apart --
    in bf16 where such rows occur, and on the same weights in float32
    (13.2 GB), where roundings rarely swap an expert, on at least one
    (step, row).  Prints each prefill layer's dropped count and largest
    slot load, each step's drops and readings, the bf16 prefill and
    decode-step times, peak memory."""
    cfg = get_arch(MOE_ARCH)
    params, n_params, _, init_s = lm_params(cfg, "moe")
    moe = cfg.moe
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    tokens, generate_s, peak = served("serve_granite", params, cfg, prompts,
                                      SERVE_NEW)
    capacity = math.ceil(
        cluster.CapacityPolicy.moe_dispatch().first_factor * SERVE_B
        * SERVE_PROMPT * moe.top_k / (moe.num_experts + moe.extra_slots))
    dev_prompts = torch.from_numpy(prompts).to(DEVICE)
    dev_tokens = torch.from_numpy(tokens).to(DEVICE)
    with torch.inference_mode():
        bf16 = moe_prefill_vs_decode(params, cfg, dev_prompts, dev_tokens,
                                     "serve_granite bf16", teacher=True)
        print(f"[moe] prefill {SERVE_B} x {SERVE_PROMPT}, bf16: dropped "
              f"assignments by layer {bf16['prefill_dropped_by_layer']}; "
              f"largest slot load by layer "
              f"{bf16['prefill_max_slot_load_by_layer']} (capacity "
              f"{capacity} a slot); decode steps' drops "
              f"{bf16['decode_dropped_by_step']}")
        params = tree_map(lambda w: w.float(), params)
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                    compute_dtype=torch.float32)
        f32 = moe_prefill_vs_decode(params, cfg32, dev_prompts, dev_tokens,
                                    "serve_granite f32", teacher=False)
        check(f32["checked"], "serve_granite f32: every (step, row) dropped "
              "or routed apart; the prefill-vs-decode check held nowhere")
    decode_ms = float(np.median(bf16["decode_step_ms"]))
    print(f"[moe] generate {SERVE_B} x {SERVE_PROMPT} + {SERVE_NEW}: "
          f"{generate_s:.2f} s first call; prefill "
          f"{bf16['prefill_ms']:.1f} ms, a decode step {decode_ms:.2f} ms "
          f"(median of {SERVE_NEW}; host clock + synchronize), peak memory "
          f"{peak / 2**30:.2f} GiB (generate, bf16); tokens "
          f"{tokens[:, :6].tolist()} ... ({smi})")
    del params
    torch.cuda.empty_cache()
    return {"parameters": n_params, "init_s": init_s,
            "generate_first_call_s": generate_s,
            "decode_step_median_ms": decode_ms,
            "max_memory_allocated_bytes": peak, "bf16": bf16, "f32": f32}


def moe_layer_params(cfg_moe, d: int, dtype, device, gen) -> dict:
    """One MoE layer's weights (``init_moe``) and a second router, the
    hot one of tests/test_moe_cluster.py:_setup (expert 0's column
    biased by linspace(0.3, 0.8, d)): {"uniform": params, "hot": params},
    sharing the experts."""
    p = moe_mod.init_moe(gen, d, cfg_moe, dtype, device)
    hot = p["router"] * 0.01
    hot[:, 0] += torch.linspace(0.3, 0.8, d, device=device)
    return {"uniform": p, "hot": {**p, "router": hot}}


def moe_oracle(p: dict, x: torch.Tensor, k: int) -> torch.Tensor:
    """The dense per-token evaluation in float32: every token through its
    own top-k experts (grouped by expert), gate-weighted."""
    gate_vals, ids = moe_mod.route(x, p["router"], k)
    gates = torch.softmax(gate_vals, dim=-1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(p["router"].shape[1]):
        tok, col = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            xe = x[tok].float()
            h = (torch.nn.functional.silu(xe @ p["w_gate"][e].float())
                 * (xe @ p["w_up"][e].float()))
            out.index_add_(0, tok, (h @ p["w_down"][e].float())
                           * gates[tok, col][:, None])
    return out


def moe_path_kernels(width: int, winner: str = "cluster") -> set:
    """The kernels one moe_dispatch call launches on (t, ``width``)
    routing rows with the plan cache cleared: the sketch's sort of the
    int32 ids and its searches, and, where the cluster dispatch runs,
    the float32 owner pair sort (the radix sort's order where the cost
    model picks radix) and its cut."""
    ids = ops.sort_kernel_choice(torch.empty((1, width), dtype=torch.int32,
                                             device=DEVICE))
    want = {"searchsorted", "radix_sort" if ids == "radix" else
            "bitonic_sort"}
    if winner == "cluster":
        want.add("radix_sort" if cost_model_family(width) == "radix"
                 else "bitonic_sort_kv")
    return want


def _check_moe_run(label: str, rep, ids: torch.Tensor, tokens: int,
                   cfg_moe) -> None:
    """The report of one dispatch against the host: the expert counts
    bitwise a recount of the routing ids the run computed, every
    assignment in a slot, and the cluster's capacity and plan from
    CapacityPolicy.moe_dispatch and its slots."""
    e, k = cfg_moe.num_experts, cfg_moe.top_k
    n_slots = e + cfg_moe.extra_slots
    recount = np.bincount(ids.cpu().numpy().reshape(-1), minlength=e)
    check(np.array_equal(rep.expert_workload, recount),
          f"{label}: expert_workload differs from a recount of the ids")
    check(int(np.asarray(rep.slot_workload).sum()) == tokens * k,
          f"{label}: slot counts sum to {int(rep.slot_workload.sum())}, not "
          f"{tokens * k}")
    if rep.dispatch_mode == "cluster":
        pol = cluster.CapacityPolicy.moe_dispatch()
        factor = pol.first_factor * pol.growth ** (rep.capacity_attempts - 1)
        check(rep.cap_factor == factor and rep.capacity == max(
            1, math.ceil(factor * tokens * k / n_slots)),
            f"{label}: capacity {rep.capacity} at factor {rep.cap_factor} "
            f"after {rep.capacity_attempts} attempts is not the policy's")
        regroup = np.bincount(rep.slot2expert, weights=rep.slot_workload,
                              minlength=e).astype(np.int64)
        check(np.array_equal(regroup, recount),
              f"{label}: slot counts regrouped to experts != the recount")


def _same_moe_report(label: str, rep, rep_cpu) -> None:
    _same_report(label, rep, rep_cpu)
    for f in ("dispatch_mode", "k_slot", "k_expert", "total_dropped",
              "capacity"):
        check(getattr(rep, f, None) == getattr(rep_cpu, f, None),
              f"{label}: {f} differs from the CPU run")
    for f in ("slot_workload", "expert_workload", "slot2expert",
              "slot_replicas"):
        check(np.array_equal(np.asarray(getattr(rep, f, 0)),
                             np.asarray(getattr(rep_cpu, f, 0))),
              f"{label}: {f} differs from the CPU run")
    if hasattr(rep_cpu, "query_plan"):
        _same_plan(label, rep.query_plan, rep_cpu.query_plan)


def moe_small_vs_cpu() -> None:
    """cluster.moe_dispatch at granite's smoke width (d 64, 8 experts,
    top-2, 4 extra slots), 512 tokens over t = 8, both routers, every
    mode, on the card against the CPU on the same weights: every report
    field and the plan equal, y within MOE_TOL."""
    cfg_s = smoke_config(get_arch(MOE_ARCH)).moe
    from repro_torch import planner
    routers = moe_layer_params(cfg_s, MOE_SMOKE_D, torch.float32, "cpu",
                               torch.Generator().manual_seed(SEED + 2))
    x = torch.randn((MOE_SMOKE_TOKENS, MOE_SMOKE_D),
                    generator=torch.Generator().manual_seed(SEED + 3))
    for name, p in routers.items():
        on_card = {n: w.to(DEVICE) for n, w in p.items()}
        for mode in MOE_MODES:
            out = {}
            for dev, pp in (("cpu", p), (DEVICE, on_card)):
                planner.clear_plan_cache()
                out[dev] = cluster.moe_dispatch(pp, x.to(dev), cfg_s,
                                                mode=mode, t_machines=MOE_T,
                                                device=dev)
            (y_c, r_c), (y_g, r_g) = out["cpu"], out[DEVICE]
            label = f"moe small {name} {mode}"
            _same_moe_report(label, r_g, r_c)
            rtol, atol = MOE_TOL
            check(torch.allclose(y_g.cpu(), y_c, rtol=rtol, atol=atol),
                  f"{label}: y differs from the CPU run by "
                  f"{max_abs_err(y_g, y_c)}")
            print(f"[moe] {label}: {r_g.algorithm} report equal to the CPU "
                  f"run, y within {max_abs_err(y_g.cpu(), y_c):.3g}, "
                  f"attempts {getattr(r_g, 'capacity_attempts', None)}, "
                  f"dropped {r_g.total_dropped}")
    planner.clear_plan_cache()


def _moe_plan_vs_cpu(label: str, p: dict, x: torch.Tensor, cfg_moe) -> dict:
    """mode="auto"'s plan on the card against the CPU's on the same
    tokens and router.  The float32 router products of the two devices
    may round a near tie of the k-th and (k+1)-th logits apart; where no
    routing id differs the plans must be equal, else the sketch of the
    card's ids on the CPU must give the card's plan."""
    from repro_torch import planner
    kw = dict(t_machines=MOE_T, num_experts=cfg_moe.num_experts,
              top_k=cfg_moe.top_k, extra_slots=cfg_moe.extra_slots,
              capacity_factor=cfg_moe.capacity_factor)
    ids = planner.plan.routing_ids(x, p["router"], t=MOE_T,
                                   top_k=cfg_moe.top_k)
    ids_cpu = planner.plan.routing_ids(x.cpu(), p["router"].cpu(), t=MOE_T,
                                       top_k=cfg_moe.top_k)
    flips = int((ids.cpu() != ids_cpu).sum())
    planner.clear_plan_cache()
    plan, _ = planner.plan_moe_query(x, p["router"], device=DEVICE, **kw)
    planner.clear_plan_cache()
    plan_cpu, _ = planner.plan_moe_query(x.cpu(), p["router"].cpu(),
                                         device="cpu", **kw)
    skw = {n: v for n, v in kw.items() if n != "t_machines"}
    if flips == 0:
        _same_plan(label, plan, plan_cpu)
    else:
        _same_plan(label, planner.plan.sketch_moe_plan(ids, **skw)[0],
                   planner.plan.sketch_moe_plan(ids.cpu(), **skw)[0])
    print(f"[moe] {label}: routing ids differing between the card and the "
          f"CPU: {flips} of {ids.numel()}; "
          + ("the plans are equal" if flips == 0 else
             "the sketch of the card's ids on both devices gives one plan")
          + f" ({plan.algorithm}; CPU {plan_cpu.algorithm})")
    planner.clear_plan_cache()
    return {"id_flips": flips, "plan": plan.algorithm,
            "plan_cpu": plan_cpu.algorithm}


def _moe_taps(compare, label: str, run, width: int) -> None:
    """One dispatch with the plan cache cleared under kernel_taps: every
    kernel call held bitwise against its plain version, the sketch's and
    the owner sort's (t, width) rows seen."""
    from repro_torch import planner
    calls = []
    planner.clear_plan_cache()
    with kernel_taps(compare, label, calls):
        run()
    rows = f"({MOE_T}, {width}) "
    check(any(n in ("bitonic_sort", "radix_sort")
              and w.startswith(rows + "int32") for n, w in calls),
          f"{label}: no sort of the {rows}int32 routing ids among {calls}")
    check(any(n in ("bitonic_sort_kv", "radix_sort")
              and w.startswith(rows + "float32") for n, w in calls),
          f"{label}: no {rows}float32 owner sort among {calls}")
    check(_called(calls, "searchsorted", rows),
          f"{label}: no search of the {rows}rows among {calls}")
    print(f"[kernels] {label}: {len(calls)} kernel calls held against "
          f"their plain versions: {sorted(set(calls))}")
    planner.clear_plan_cache()


def phase_moe_cluster(smi: str, errs: dict) -> dict:
    """``cluster.moe_dispatch`` on one granite-moe-3b-a800m MoE layer at
    full width (d 1536, 40 experts of 512, top-8, bf16 experts, float32
    tokens), 8192 tokens over t = 8, a uniform and a hot router, in
    every mode (``auto`` first, cached and with the cache bypassed), and
    one dbrx-132b layer (d 6144, 16 experts of 10752, top-4) in
    ``cluster`` mode on 2048 tokens.  Checks: cluster and alpha_k (and
    capacity where it drops nothing) against the dense oracle within
    MOE_TOL; expert counts bitwise a host recount; capacity and attempts
    the policy's; ``auto``'s plan the CPU's; every kernel call held
    against its plain version (kernel_taps); the launches of each path.
    Then the smoke width on the card against the CPU.  Times: median of
    5 per mode, peak memory."""
    from repro_torch import planner
    compare = comparer(errs)
    out = {}
    for arch in (MOE_ARCH, MOE_WIDE_ARCH):
        cfg = get_arch(arch)
        cfg_moe, d = cfg.moe, cfg.d_model
        tokens = MOE_TOKENS[arch]
        width = tokens // MOE_T * cfg_moe.top_k
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        routers = moe_layer_params(cfg_moe, d, cfg.param_dtype, DEVICE, gen)
        x = torch.randn((tokens, d), generator=gen, device=DEVICE)
        tag = "granite" if arch == MOE_ARCH else "dbrx"
        # dbrx: one router, the cluster mode (the dense modes gather every
        # slot's 0.4 GB of weights at once)
        modes = MOE_MODES if arch == MOE_ARCH else ("cluster",)
        names = ("uniform", "hot") if arch == MOE_ARCH else ("uniform",)
        print(f"[moe] {arch} layer: d {d}, {cfg_moe.num_experts} experts of "
              f"{cfg_moe.d_ff_expert}, top-{cfg_moe.top_k}, "
              f"{cfg_moe.extra_slots} extra slots; {tokens} tokens over t = "
              f"{MOE_T} (routing rows ({MOE_T}, {width})); experts "
              f"{3 * cfg_moe.num_experts * d * cfg_moe.d_ff_expert * 2 / 1e9:.2f}"
              f" GB in {str(cfg.param_dtype)[6:]}")
        for name in names:
            p = routers[name]
            label = f"{tag} {name}"
            kw = dict(t_machines=MOE_T, device=DEVICE)
            ids_dense = moe_mod.route(x, p["router"], cfg_moe.top_k)[1]
            ids_cluster = planner.plan.routing_ids(
                x, p["router"], t=MOE_T, top_k=cfg_moe.top_k)
            oracle = moe_oracle(p, x, cfg_moe.top_k)
            runs = {}
            for mode in modes:
                planner.clear_plan_cache()
                torch.cuda.reset_peak_memory_stats()
                path = (f"moe_{mode}_{tag}_{name}"
                        if mode in ("cluster", "auto") else None)
                call = functools.partial(cluster.moe_dispatch, p, x, cfg_moe,
                                         mode=mode, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, rep = on_path(path, call) if path else call()
                first_ms = _ms_since(t0)
                peak = torch.cuda.max_memory_allocated()
                if path is not None:
                    PATH_KERNELS[path] = moe_path_kernels(
                        width, rep.dispatch_mode)
                ids = (ids_cluster if rep.dispatch_mode == "cluster"
                       else ids_dense)
                _check_moe_run(f"moe {label} {mode}", rep, ids, tokens,
                               cfg_moe)
                err = max_abs_err(y, oracle)
                if rep.total_dropped == 0:
                    rtol, atol = MOE_TOL
                    check(torch.allclose(y, oracle, rtol=rtol, atol=atol),
                          f"moe {label} {mode}: y differs from the dense "
                          f"oracle by {err}")
                else:
                    check(mode == "capacity", f"moe {label} {mode} dropped "
                          f"{rep.total_dropped} assignments")
                runs[mode] = {"algorithm": rep.algorithm,
                              "dropped": rep.total_dropped,
                              "max_abs_err_vs_oracle": err,
                              "k_slot": rep.k_slot, "k_expert": rep.k_expert,
                              "capacity": getattr(rep, "capacity", None),
                              "attempts": getattr(rep, "capacity_attempts",
                                                  None),
                              "first_call_peak_bytes": peak}
                print(f"[moe] {label} {mode}: {rep.algorithm}, dropped "
                      f"{rep.total_dropped}, k_slot {rep.k_slot:.3f}, "
                      f"k_expert {rep.k_expert:.3f}, capacity "
                      f"{getattr(rep, 'capacity', '-')}, attempts "
                      f"{getattr(rep, 'capacity_attempts', '-')}, max abs "
                      f"err vs the oracle {err:.3g}"
                      + ("" if rep.total_dropped == 0 else " (not held: drops)"))
                runs[mode]["first_call_ms"] = first_ms
                runs[mode]["times"] = e2e(
                    f"moe {label} {mode}" + (" (plan cached)" if mode in (
                        "cluster", "auto") else ""), call, smi)
                if mode == "auto":
                    def bypassed(call=call):
                        planner.clear_plan_cache()
                        return call()
                    runs["auto"]["bypassed"] = e2e(
                        f"moe {label} auto (cache bypassed)", bypassed, smi)
            if "auto" in modes:
                runs["plan_vs_cpu"] = _moe_plan_vs_cpu(f"moe {label} auto",
                                                       p, x, cfg_moe)
            _moe_taps(compare, f"moe {label} cluster", functools.partial(
                cluster.moe_dispatch, p, x, cfg_moe, mode="cluster", **kw),
                width)
            out[f"{tag}_{name}"] = runs
        del routers, x
        torch.cuda.empty_cache()
    moe_small_vs_cpu()
    return out


# ---------------------------------------------------------------------------
# 6b. the staged exchange, the planner and tracing
# ---------------------------------------------------------------------------

# (algorithm, exchange) -> the name of the keys-only path that runs it
TOPOLOGY_PATHS = {("smms", "flat"): "sort", ("terasort", "flat"): "terasort",
                  ("smms", "staged"): "sort_staged",
                  ("terasort", "staged"): "terasort_staged"}
# the planner's sketch round: a keys-only sort of each sampled shard
# (512 keys) and two searches of it against itself
SKETCH_KERNELS = {"bitonic_sort", "searchsorted"}
T_STAGED_SMALL = 16         # 4 x 4: the small staged runs against the CPU


def staged_path(algorithm: str, payload: bool) -> str:
    return (TOPOLOGY_PATHS[(algorithm, "staged")]
            + ("_payload" if payload else ""))


def staged_and_auto_operands(compare) -> None:
    """The kernels at the operands the staged exchange and the planner
    hand them, every call held bitwise against its plain version on the
    same card tensors (:func:`kernel_taps`).

    SMMS and Terasort staged at t = 64 (8 x 8) on uniform keys, keys
    only, as f32 and as bf16: the rank merges of the stage-1 landed
    rows, the two stage-2 chunks and the cross-chunk merge; the
    restage's per-row (64, 7) searches of the merged rows; the sorts
    and cuts of Rounds 1-3.  The f32 runs' first merge of each shape is
    kept in :data:`RANK_OPERANDS` (timed in phase 8), and SMMS's stage-1
    rows are held again with a NaN in entry 5 (the merge, then its
    replay).  Then ``algorithm="auto"`` on the uniform and Zipf sorts
    and the Zipf and scalar-skew joins, the plan cache cleared: the
    sketch's sort of the (64, 512) sampled shards and its two
    self-searches, left and right, and the winner's kernels."""
    from repro_torch import planner
    from repro_torch.launch import factor_shards
    _, t2 = factor_shards(T)
    inputs = sort_inputs(SEED)
    x = inputs["uniform"][0]
    names = ("s1", "chunk", "chunk", "cross")
    for algorithm in PATHS:
        for dtype in ("f32", "bf16"):
            merges, calls = [], []

            def keep(name, args):
                if name != "merge_ranks":
                    return
                if dtype == "f32":
                    label = f"{algorithm}_staged_{names[min(len(merges), 3)]}"
                    RANK_OPERANDS.setdefault(label, args[0].cpu())
                merges.append(tuple(args[0].shape))

            xin = x if dtype == "f32" else torch.from_numpy(x).to(
                torch.bfloat16)
            with kernel_taps(compare, f"{algorithm} staged {dtype}", calls,
                             keep):
                cluster.sort(xin, algorithm=algorithm, seed=SEED,
                             exchange="staged", device=DEVICE)
            print(f"[kernels] {algorithm} staged {dtype} at t={T}: rank "
                  f"merges of {merges}")
            check(len(merges) == 4, f"{algorithm} staged {dtype}: "
                  f"{len(merges)} rank merges, expected 4 (s1, 2 chunks, "
                  f"cross)")
            check(_called(calls, "searchsorted", f"x ({T}, {t2 - 1}) "),
                  f"{algorithm} staged {dtype}: no per-row ({T}, {t2 - 1}) "
                  f"restage search among {calls}")
    keys = RANK_OPERANDS["smms_staged_s1"].clone()
    e, r, c = keys.shape[0] // 2, keys.shape[1] - 1, keys.shape[2]
    keys[e, 0, 0] = keys[e, r // 2, c // 4] = keys[e, r, c // 2] = math.nan
    keys = keys.to(torch.device(DEVICE))
    compare("merge_ranks_replay", f"smms_staged_s1 {tuple(keys.shape)}, "
            f"NaN in entry {e}", fused.rank_merge(keys),
            fused.rank_merge_plain(keys))
    sample = f"({T}, {planner.sketch.SKETCH_SAMPLE})"
    runs = [(f"sort auto {name}", lambda x=inputs[name][0]: cluster.sort(
        x, algorithm="auto", exchange="auto", seed=SEED, device=DEVICE))
        for name in ("uniform", "zipf")]
    for name in ("zipf", "scalar_skew"):
        s, t = JOINS[f"statjoin_{name}"].tables()
        runs.append((f"join auto {name}", lambda s=s, t=t: cluster.join(
            s, np.arange(len(s), dtype=np.int32), t,
            np.arange(len(t), dtype=np.int32), algorithm="auto",
            t_machines=JOIN_T, seed=SEED, device=DEVICE)))
    for label, run in runs:
        calls = []
        planner.clear_plan_cache()
        with kernel_taps(compare, label, calls):
            run()
        sorts = [w for n, w in calls if n in ("bitonic_sort", "radix_sort")
                 and w.startswith(sample)]
        check(any(all(_called(calls, "searchsorted",
                              f"{sample} x {sample} {w.split()[-1]}, {side}")
                      for side in ("left", "right")) for w in sorts),
              f"{label}: the sketch's sort and self-searches of the "
              f"{sample} shards not seen among {calls}")
        print(f"[kernels] {label}: sketch calls {sorted(set(sorts))}, "
              f"{len(calls)} kernel calls held against their plain "
              f"versions")
    planner.clear_plan_cache()


def _same_pairs(label: str, keys, vals, keys_flat, vals_flat) -> None:
    """Staged against flat with values: the same keys, and the same
    records for each key -- equal keys may order their records otherwise
    (in the reference too), so both sides are put in (key, row id) order
    first (column 0 of the payload is the row's global id)."""
    check(same_bits(keys, keys_flat), f"{label}: keys differ from flat")

    def in_id_order(k, v):
        order = torch.argsort(v[:, 0], stable=True)
        order = order[torch.argsort(k[order], stable=True)]
        return v[order]

    check(torch.equal(in_id_order(keys, vals),
                      in_id_order(keys_flat, vals_flat)),
          f"{label}: records differ from the flat run's")


def _staged_report(label: str, rep, rep_flat, t2: int) -> None:
    """Every report field the two topologies share, equal: algorithm,
    sizes, workload, k_workload, the Round-2 phase, the boundaries and
    the theorem's bound; alpha one more; the samples gathered in two
    hops (each machine sends its count, then t2 times it); stage 2
    landing each machine's workload; stage 1 and 2 landing n in all.
    The capacity schedule (cap_factor, attempts) is each topology's own:
    the staged tiles hold m/t1- and m/t2-scale pair loads."""
    for field in ("algorithm", "n_in", "n_out", "k_workload",
                  "theoretical_workload_bound"):
        check(getattr(rep, field) == getattr(rep_flat, field),
              f"{label}: {field} differs from the flat run")
    check(np.array_equal(rep.workload, rep_flat.workload),
          f"{label}: workload differs from the flat run")
    check(np.array_equal(rep.boundaries.view(np.int32),
                         rep_flat.boundaries.view(np.int32)),
          f"{label}: boundaries differ from the flat run")
    check(rep.alpha == rep_flat.alpha + 1 == 4,
          f"{label}: alpha {rep.alpha}, flat {rep_flat.alpha}")
    check(rep.exchange_topology == "staged", f"{label}: ran flat")
    ph, fl = ({p.name: p for p in r.phases} for r in (rep, rep_flat))
    check(set(ph) == {"round1->2 samples", "round2 boundaries",
                      "round3 shuffle s1", "round3 shuffle s2"},
          f"{label}: phases {sorted(ph)}")
    for f in ("sent", "received"):
        check(np.array_equal(getattr(ph["round2 boundaries"], f),
                             getattr(fl["round2 boundaries"], f)),
              f"{label}: round 2 differs from the flat run")
    s, fs = ph["round1->2 samples"], fl["round1->2 samples"]
    t = len(fs.sent)
    check(np.array_equal(s.sent, fs.sent * (1 + t2))
          and np.array_equal(s.received, fs.sent * (t2 + t)),
          f"{label}: the two-hop sample gather's counts")
    n = rep.n_in
    check(np.array_equal(ph["round3 shuffle s2"].received, rep.workload)
          and ph["round3 shuffle s1"].received.sum() == n,
          f"{label}: the stages' landed counts")


def phase_staged(smi: str) -> dict:
    """The staged exchange at t = 64 x 65,536 (8 x 8): SMMS and Terasort,
    keys only and with the 100-byte records, by the cost model's family,
    on the four inputs, held against the flat run on the card (keys,
    records, workload and every shared report field; alpha one more);
    the medians and peaks of both topologies on the uniform keys; a
    traced run of each topology with its phase spans against the report
    and ``obs.timeit`` against the host clock; then t = 16 (4 x 4) with
    values against the CPU run on the same draws."""
    from repro_torch.launch import factor_shards
    _, t2 = factor_shards(T)
    out = {}
    for algorithm in PATHS:
        for payload in (False, True):
            path = staged_path(algorithm, payload)
            for i, (name, (x, _, _)) in enumerate(sort_inputs(SEED).items()):
                vals = (make_payload(T, M, SEED + i, device=DEVICE)
                        if payload else None)
                kw = dict(algorithm=algorithm, seed=SEED, values=vals,
                          device=DEVICE)
                (kf, vf), rf = cluster.sort(x, **kw)
                (ks, vs), rs = on_path(path, lambda: cluster.sort(
                    x, exchange="staged", **kw))
                label = f"{path} {name}"
                if payload:
                    _same_pairs(label, ks, vs, kf, vf)
                else:
                    check(same_bits(ks, kf), f"{label}: keys differ from "
                                             f"the flat run")
                _staged_report(label, rs, rf, t2)
                print(f"[staged] {label:36s} ok: keys"
                      f"{', records' if payload else ''}, workload and the "
                      f"shared report fields equal to the flat run; alpha "
                      f"{rs.alpha}; capacity attempts staged "
                      f"{rs.capacity_attempts} / flat {rf.capacity_attempts}"
                      f", k_network {rs.k_network:.4f} / {rf.k_network:.4f}")
                if name == "uniform":
                    run = lambda ex: cluster.sort(x, exchange=ex, **kw)
                    out[path] = {ex: e2e(f"{path} uniform {ex}",
                                         lambda: run(ex), smi, reps=5)
                                 for ex in ("flat", "staged")}
                del vals, kf, vf, ks, vs
    out["tracing"] = phase_tracing(smi)
    phase_small_staged()
    return out


def phase_tracing(smi: str) -> dict:
    """One traced SMMS sort by each topology at t = 64: the span tree's
    ``phase:*`` children equal to the report's phases, bitwise; then
    ``obs.timeit`` of the flat sort (it synchronizes the card) against
    the host-clock medians of the same call."""
    from repro_torch import obs
    x = sort_inputs(SEED)["uniform"][0]
    for exchange in ("flat", "staged"):
        tracer = obs.Tracer(enabled=True)
        with tracer.trace("q") as root:
            _, rep = cluster.sort(x, exchange=exchange, device=DEVICE)
        runs = [s for s in root.walk() if s.name == "substrate.run"]
        kids = runs[-1].children
        check([c.name for c in kids] == [f"phase:{p.name}"
                                         for p in rep.phases]
              and all(np.array_equal(c.attrs["sent"], p.sent)
                      and np.array_equal(c.attrs["received"], p.received)
                      for c, p in zip(kids, rep.phases)),
              f"traced {exchange} sort: phase spans != the report's phases")
        ops_seq = [e.attrs["op"] for s in root.walk() for e in s.events
                   if e.name == "kernel_dispatch"]
        print(f"[staged] traced SMMS {exchange}: {len(runs)} substrate.run, "
              f"phase spans {[c.name for c in kids]} equal to the report, "
              f"bitwise; dispatches {ops_seq}")
    fn = lambda: cluster.sort(x, device=DEVICE)
    walls = e2e("sort uniform flat (beside obs.timeit)", fn, smi, reps=5)
    res = obs.timeit(fn, reps=5, warmup=1)
    lo, hi = min(walls["ms"]), max(walls["ms"])
    best = res.best_s * 1e3
    check(lo / 1.5 <= best <= hi * 1.5,
          f"obs.timeit best {best:.3f} ms outside the host clock's "
          f"[{lo:.3f}, {hi:.3f}] ms (x 1.5)")
    print(f"[staged] obs.timeit best {best:.3f} ms, mean "
          f"{res.mean_s * 1e3:.3f} ms of 5; host clock + synchronize "
          f"{lo:.3f}-{hi:.3f} ms ({smi})")
    return {"timeit_best_ms": best, "timeit_ms": [s * 1e3
                                                  for s in res.times_s],
            "host_clock_ms": walls["ms"],
            "hooks_off": hook_costs(x, walls["median_ms"], smi)}


def _per_call_us(fn, n: int = 20000, reps: int = 5) -> float:
    """Best of ``reps`` host-clock means of ``n`` back-to-back calls."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def hook_costs(x, sort_ms: float, smi: str) -> dict:
    """What the observability hooks add to an untraced flat SMMS sort,
    on the host: ``ops._tick`` on a card tensor against its dispatch
    count alone (all the tick did before the hooks), and
    ``BatchedSubstrate.run`` of an empty body against the body called
    on a fresh tape, each the mean of 20,000 calls; times one sort's
    dispatches and runs.  Beside them what counting a launch under
    ``cuda._COUNT_LOCK`` (the query engine launches from several
    threads) costs against the bare count, times one sort's launches.
    The probes' counts are taken out again."""
    from repro_torch.cluster import BatchedSubstrate, CollectiveTape
    probe = torch.zeros(1, device=DEVICE)
    key = ("obs_probe", "cuda")

    def count_only():
        with ops._COUNTS_LOCK:
            ops.DISPATCH_COUNTS[key] += 1

    def launch_count_locked():
        with cuda._COUNT_LOCK:
            cuda.LAUNCHES["obs_probe"] += 1

    def launch_count_bare():
        cuda.LAUNCHES["obs_probe"] += 1

    def body(*, tape):
        return None

    sub = BatchedSubstrate(T)
    tick_us = _per_call_us(lambda: ops._tick("obs_probe", probe))
    count_us = _per_call_us(count_only)
    run_us = _per_call_us(lambda: sub.run(body))
    bare_us = _per_call_us(lambda: body(tape=CollectiveTape()))
    locked_us = _per_call_us(launch_count_locked)
    unlocked_us = _per_call_us(launch_count_bare)
    ops.DISPATCH_COUNTS.pop(key, None)
    cuda.LAUNCHES.pop("obs_probe", None)
    before = collections.Counter(ops.DISPATCH_COUNTS)
    torch.cuda.synchronize()
    launches_before = sum(cuda.LAUNCHES.values())
    _, rep = cluster.sort(x, device=DEVICE)
    torch.cuda.synchronize()
    launches = sum(cuda.LAUNCHES.values()) - launches_before
    dispatches = sum((ops.DISPATCH_COUNTS - before).values())
    runs = rep.capacity_attempts
    added_us = (dispatches * (tick_us - count_us)
                + runs * (run_us - bare_us))
    lock_added_us = launches * (locked_us - unlocked_us)
    print(f"[staged] tracing off, host: ops._tick {tick_us:.3f} us against "
          f"{count_us:.3f} us for the count alone; substrate.run "
          f"{run_us:.3f} us against {bare_us:.3f} us for the body; one "
          f"flat SMMS sort: {dispatches} dispatches, {runs} run(s), "
          f"{added_us:.2f} us added = {added_us / 10 / sort_ms:.4f}% of "
          f"its {sort_ms:.3f} ms median ({smi})")
    print(f"[staged] a launch counted under cuda._COUNT_LOCK: "
          f"{locked_us:.3f} us against {unlocked_us:.3f} us bare; one flat "
          f"SMMS sort counts {launches} launches: {lock_added_us:.3f} us "
          f"added = {lock_added_us / 10 / sort_ms:.5f}% of its "
          f"{sort_ms:.3f} ms median ({smi})")
    return {"tick_us": tick_us, "count_only_us": count_us,
            "substrate_run_us": run_us, "bare_body_us": bare_us,
            "dispatches_per_sort": dispatches, "runs_per_sort": runs,
            "added_us_per_sort": added_us, "sort_median_ms": sort_ms,
            "launch_count_locked_us": locked_us,
            "launch_count_bare_us": unlocked_us,
            "launches_per_sort": launches,
            "lock_added_us_per_sort": lock_added_us}


def phase_small_staged() -> None:
    """SMMS and Terasort staged at t = 16 x 4,096 (4 x 4: the in-tile
    merges) with (t, m, 3) values: keys, values, boundaries and every
    report field equal to the CPU run on the same draws."""
    t, m = T_STAGED_SMALL, M_SMALL
    x = lidar_like(t * m, seed=SEED + 5).reshape(t, m)
    u = torch.rand((t, m), generator=torch.Generator().manual_seed(SEED))
    v = np.random.default_rng(SEED + 5).integers(
        0, 1 << 30, (t, m, 3)).astype(np.int32)
    for algorithm in PATHS:
        path = f"small_{TOPOLOGY_PATHS[(algorithm, 'staged')]}_values"
        kw = dict(algorithm=algorithm, values=v, exchange="staged",
                  uniforms=u if algorithm == "terasort" else None)
        with ops.force_sort_kernel(forced_family("bitonic", m)):
            (keys, vals), rep = on_path(path, lambda: cluster.sort(
                x, device=DEVICE, **kw))
        (kc, vc), rc = cluster.sort(x, device="cpu", **kw)
        check(same_bits(keys, kc) and same_bits(vals, vc),
              f"{path}: card keys or values != CPU")
        check(np.array_equal(rep.boundaries.view(np.int32),
                             rc.boundaries.view(np.int32))
              and rep.exchange_topology == rc.exchange_topology == "staged",
              f"{path}: boundaries or topology differ from the CPU run")
        _same_report(path, rep, rc)
        print(f"[small] {algorithm} staged t={t} (4 x 4) m={m} with values: "
              f"keys, values, boundaries and every report field equal to "
              f"the CPU run on the same draws, bitwise")


# ---------------------------------------------------------------------------
# multiproc: the process-group substrate (ROADMAP A7's cluster half)
# ---------------------------------------------------------------------------

MULTIPROC_RANKS = 2              # the Gloo ranks that share the card
MULTIPROC_WAIT_S = 300           # the two ranks, start to finish
MULTIPROC_GROUP_TIMEOUT_S = 120  # any one collective's wait
MULTIPROC_REPS = 3
MULTIPROC_JOINS = ("statjoin_zipf", "randjoin_zipf")


def _report_fields(rep) -> dict:
    """Every comparable field of a report, host values: the MoE
    dispatch's and the planner's too (the plan's algorithm, topology and
    every candidate's costs, the sketch round's phases)."""
    out = report_fields(rep)
    for key in ("boundaries", "exchange_topology",
                "theoretical_workload_bound", "total_dropped",
                "dispatch_mode", "slot_workload", "expert_workload",
                "k_slot", "k_expert", "capacity", "slot2expert",
                "slot_replicas", "predicted_alpha", "predicted_k",
                "predicted_k_network"):
        if hasattr(rep, key):
            out[key] = getattr(rep, key)
    plan = getattr(rep, "query_plan", None)
    if plan is not None:
        out["plan"] = (plan.algorithm, plan.exchange, {
            name: dataclasses.asdict(c)
            for name, c in sorted(plan.candidates.items())})
        out["sketch_phases"] = [(p.name, np.asarray(p.sent),
                                 np.asarray(p.received))
                                for p in rep.sketch_phases]
    return out


def _same_fields(a, b) -> bool:
    if isinstance(b, dict):
        return set(a) == set(b) and all(_same_fields(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_fields(x, y)
                                        for x, y in zip(a, b))
    if isinstance(b, np.ndarray):
        a = np.asarray(a)
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return a == b


def _same_run(label: str, got, want) -> None:
    """A process-group run against the batch's: every output tensor
    bitwise (sort keys and values, every JoinOutput field) and every
    report field."""
    (value, rep), (value_b, rep_b) = got, want
    if isinstance(value, torch.Tensor):         # an MoE layer's y
        value, value_b = (value,), (value_b,)
    check(len(value) == len(value_b)
          and all((a is None) == (b is None) for a, b in zip(value, value_b))
          and all(same_bits(a, b) for a, b in zip(_value_tensors(value),
                                                  _value_tensors(value_b))),
          f"{label}: output differs from the batch's")
    check(_same_fields(_report_fields(rep), _report_fields(rep_b)),
          f"{label}: report differs from the batch's")


def multiproc_calls(x, vals, uniforms, joins: dict) -> dict:
    """path -> (the call on a substrate provider, the batch twin's call
    or None: the same call).  Every sort and join of the phase."""
    def sort(**kw):
        return lambda pool: cluster.sort(x, seed=SEED, device=DEVICE,
                                         substrate=pool, **kw)

    def join(name):
        cfg, (s, t) = JOINS[name], joins[name]
        rows = (np.arange(len(s), dtype=np.int32),
                np.arange(len(t), dtype=np.int32))
        return lambda pool: cluster.join(
            s, rows[0], t, rows[1], algorithm=cfg.algorithm,
            t_machines=JOIN_T, seed=SEED, device=DEVICE, substrate=pool,
            **cfg.options)

    calls = {"multiproc_sort": (sort(), None),
             "multiproc_sort_payload": (sort(values=vals), None),
             "multiproc_sort_ragged": (sort(backend="ragged"), sort()),
             "multiproc_sort_staged": (sort(exchange="staged"), None),
             "multiproc_terasort": (sort(algorithm="terasort",
                                         uniforms=uniforms), None)}
    for name in joins:
        calls[f"multiproc_{name.split('_')[0]}"] = (join(name), None)
    return calls


def ragged_sort_kernel() -> tuple:
    """(kernel, width) of the ragged backend's re-sort of the (t,
    capacity) landed rows: SMMS's Theorem-1 capacity at t x m, past the
    bitonic tile at the phase's size, so the radix sort."""
    from repro_torch.core.smms import default_cap_factor
    width = flat_receive_capacity(M, T, default_cap_factor(T * M, T, 2))
    return ("radix_sort" if cost_model_family(width) == "radix"
            else "bitonic_sort"), width


def multiproc_kernels() -> None:
    """The multiproc paths' launch sets: the batch paths' of the same
    calls, and the ragged re-sort's (:func:`ragged_sort_kernel`)."""
    fam = cost_model_family(M)
    sort = PATH_KERNELS[path_name("smms", False, fam)]
    ragged = (sort - RANK_MERGE) | {ragged_sort_kernel()[0]}   # no merge
    PATH_KERNELS.update({
        "multiproc_sort": sort,
        "multiproc_sort_payload": PATH_KERNELS[path_name("smms", True, fam)],
        "multiproc_sort_ragged": ragged,
        "multiproc_sort_staged": PATH_KERNELS["sort_staged"],
        "multiproc_terasort": PATH_KERNELS[path_name("terasort", False, fam)],
        "multiproc_statjoin": PATH_KERNELS["statjoin_zipf"],
        "multiproc_randjoin": PATH_KERNELS["randjoin_zipf"],
        "multiproc_small_sort": PATH_KERNELS["small_sort"],
        "multiproc_small_sort_values": PATH_KERNELS["small_sort_values"],
        "multiproc_gloo_sort": sort,
        "multiproc_gloo_sort_ragged": ragged,
        "multiproc_gloo_statjoin": PATH_KERNELS["statjoin_zipf"]})


def phase_multiproc(smi: str, errs: dict) -> dict:
    """The process-group substrate (``ProcessGroupSubstrate``) on the card.

    One NCCL rank in this process, holding all t = 64 machines: SMMS
    keys only, with the 100-byte records, ``backend="ragged"`` and
    staged (8 x 8), Terasort on injected draws, StatJoin and RandJoin on
    the §5.2 Zipf tables, and the small t = 8 sorts (the in-tile
    merges), each bitwise the BatchedSubstrate run on the card in every
    output and report field (ragged: the static run's), its launches
    counted; every kernel call of one ragged run held against its plain
    version; the median of 3 beside the batch's.  Then two Gloo ranks
    on this card (:func:`gloo_rank_main`, 32 machines a rank): SMMS flat
    and ragged, the auto sort and StatJoin, every rank's whole result
    equal to its own batch run, whether the tape staged through the
    host, the ms.  The one rank also runs the planner and the MoE
    dispatch on the group (:func:`multiproc_planner_calls`), their
    launch sets those of their batch runs."""
    import datetime

    import torch.distributed as dist
    from repro_torch.cluster import ProcessGroupSubstrate, SubstratePool
    multiproc_kernels()
    x = sort_inputs(SEED)["uniform"][0]
    joins = {name: JOINS[name].tables() for name in MULTIPROC_JOINS}
    calls = multiproc_calls(x, make_payload(T, M, SEED, device=DEVICE),
                            draw_uniforms(T, M, SEED + 1, DEVICE), joins)
    xs = zipf_keys(T_SMALL * M_SMALL, seed=SEED + 2).reshape(T_SMALL, M_SMALL)
    vs = make_payload(T_SMALL, M_SMALL, SEED + 2, cols=3, device=DEVICE)
    small = forced_family("bitonic", M_SMALL)
    for path, kw in (("multiproc_small_sort", {}),
                     ("multiproc_small_sort_values", {"values": vs})):
        calls[path] = (lambda pool, kw=kw: _forced(small, lambda: cluster.sort(
            xs, device=DEVICE, substrate=pool, **kw)), None)
    calls.update(multiproc_planner_calls(x, joins["statjoin_zipf"]))
    out = {}
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if DEVICE == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/pg", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=MULTIPROC_GROUP_TIMEOUT_S))
        try:
            group = SubstratePool(make=ProcessGroupSubstrate)
            batch = SubstratePool()
            wants = {}
            for path, (run, twin) in calls.items():
                key = "multiproc_sort" if twin is not None else path
                if key not in wants:
                    torch.cuda.synchronize()
                    cuda.reset_launches()
                    wants[key] = (twin or run)(batch)
                    torch.cuda.synchronize()
                    if path in MULTIPROC_FROM_BATCH:
                        PATH_KERNELS[path] = {k for k, n in
                                              cuda.LAUNCHES.items() if n}
                want = wants[key]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = on_path(path, lambda: run(group))
                first = (time.perf_counter() - t0) * 1e3
                _same_run(path, got, want)
                del got
                ms = e2e(f"{path} one NCCL rank", lambda: run(group), smi,
                         reps=MULTIPROC_REPS)
                ms_b = e2e(f"{path} batch", lambda: (twin or run)(batch), smi,
                           reps=MULTIPROC_REPS)
                print(f"[multiproc] {path:28s} ok: bitwise the batch run in "
                      f"every output and report field; median of "
                      f"{MULTIPROC_REPS} {ms['median_ms']:.2f} ms on one "
                      f"{backend} rank, batch {ms_b['median_ms']:.2f} ms; "
                      f"first call {first:.1f} ms ({smi})")
                out[path] = {"ms": ms["ms"], "batch_ms": ms_b["ms"],
                             "median_ms": ms["median_ms"],
                             "batch_median_ms": ms_b["median_ms"],
                             "first_call_ms": first}
            calls_seen = []
            with kernel_taps(comparer(errs), "multiproc ragged", calls_seen):
                calls["multiproc_sort_ragged"][0](group)
            kernel, width = ragged_sort_kernel()
            check(_called(calls_seen, kernel, f"({T}, {width})"),
                  f"the ragged re-sort ({kernel} of ({T}, {width})) not "
                  f"among {calls_seen}")
            print(f"[multiproc] one ragged run: {len(calls_seen)} kernel "
                  f"calls held against their plain versions, bitwise")
            check(not group.stats().get("host_staged_runs"),
                  f"a {backend} rank staged through the host")
            out["group_runs"] = group.stats()["runs"]
            PATH_KERNELS["multiproc_gloo_sort_auto"] = PATH_KERNELS[
                "multiproc_sort_auto"]
            del wants
        finally:
            dist.destroy_process_group()
        out["gloo"] = multiproc_gloo(smi, tmp, x, joins["statjoin_zipf"])
    return out


def _forced(family, fn):
    with ops.force_sort_kernel(family):
        return fn()


# the paths whose launch sets are those of the batch run of the same call
MULTIPROC_FROM_BATCH = ("multiproc_sort_auto", "multiproc_join_auto",
                        "multiproc_moe_cluster", "multiproc_moe_auto")


def _fresh(fn):
    """``fn()`` with the plan cache cleared first: every call sketches."""
    from repro_torch import planner
    planner.clear_plan_cache()
    return fn()


def multiproc_planner_calls(x, tables) -> dict:
    """The planner and the MoE dispatch on the group: ``algorithm="auto"``
    on the t = 64 sort keys and on the §5.2 Zipf tables; and
    ``cluster.moe_dispatch`` in ``cluster`` and ``auto`` modes on one
    granite-moe-3b-a800m layer at its published widths (bf16 experts,
    float32 tokens, MOE_TOKENS over t = MOE_T).  Each call clears the
    plan cache first, so each sketches on the substrate it is given."""
    cfg = get_arch(MOE_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    p = moe_layer_params(cfg.moe, cfg.d_model, cfg.param_dtype, DEVICE,
                         gen)["uniform"]
    xm = torch.randn((MOE_TOKENS[MOE_ARCH], cfg.d_model), generator=gen,
                     device=DEVICE)
    s, t = tables
    rows = (np.arange(len(s), dtype=np.int32),
            np.arange(len(t), dtype=np.int32))

    def moe(mode):
        return lambda pool: _fresh(lambda: cluster.moe_dispatch(
            p, xm, cfg.moe, mode=mode, t_machines=MOE_T, device=DEVICE,
            substrate=pool))

    return {
        "multiproc_sort_auto": (lambda pool: _fresh(lambda: cluster.sort(
            x, algorithm="auto", seed=SEED, device=DEVICE, substrate=pool)),
            None),
        "multiproc_join_auto": (lambda pool: _fresh(lambda: cluster.join(
            s, rows[0], t, rows[1], algorithm="auto", t_machines=JOIN_T,
            seed=SEED, device=DEVICE, substrate=pool)), None),
        "multiproc_moe_cluster": (moe("cluster"), None),
        "multiproc_moe_auto": (moe("auto"), None)}


def multiproc_gloo(smi: str, tmp: str, x: np.ndarray, tables) -> dict:
    """Two Gloo ranks on the card, each a process running
    :func:`gloo_rank_main`; their launches are added to the paths'."""
    root = pathlib.Path(tmp) / "gloo"
    root.mkdir()
    np.savez(root / "inputs.npz", x=x, s=tables[0], t=tables[1])
    (root / "settings.json").write_text(json.dumps(
        {"device": DEVICE, "t": T, "join_t": JOIN_T}))
    logs = [open(root / f"rank{r}.log", "w") for r in range(MULTIPROC_RANKS)]
    # Gloo's ranks meet on the loopback device: the machine needs no
    # network for them
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-rank", str(r),
         str(MULTIPROC_RANKS), str(root)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(MULTIPROC_RANKS)]
    deadline = time.monotonic() + MULTIPROC_WAIT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for r, p in enumerate(procs):
        text = (root / f"rank{r}.log").read_text()
        for line in text.splitlines():
            if line.startswith("[multiproc"):
                print(f"[multiproc gloo rank {r}] {line}")
        check(p.returncode == 0 and (root / f"rank{r}.json").exists(),
              f"Gloo rank {r} of {MULTIPROC_RANKS} failed (exit "
              f"{p.returncode}):\n{text[-4000:]}")
        results.append(json.loads((root / f"rank{r}.json").read_text()))
    for res in results:
        for path, counts in res["launches"].items():
            PATH_LAUNCHES[path].update(counts)
    staged = [res["host_staged_runs"] for res in results]
    print(f"[multiproc] {MULTIPROC_RANKS} Gloo ranks on one card: every "
          f"rank's whole results equal to its batch run; the tape staged "
          f"through pinned host memory in {staged} runs a rank; medians "
          + ", ".join(f"{p} {np.median(results[0]['ms'][p]):.2f} ms (batch "
                      f"{np.median(results[0]['batch_ms'][p]):.2f})"
                      for p in results[0]["ms"]) + f" ({smi})")
    return {"ranks": results}


def gloo_rank_main(rank: int, world: int, root: str) -> None:
    """One Gloo rank of :func:`multiproc_gloo`: SMMS flat and ragged and
    StatJoin on ``ProcessGroupSubstrate(t)`` (t / world machines here),
    each whole result bitwise this process's own batch run; the medians
    of 3, the batch's timed on rank 0 while the others wait."""
    import datetime

    import torch.distributed as dist
    from repro_torch.cluster import ProcessGroupSubstrate, SubstratePool
    global DEVICE
    root = pathlib.Path(root)
    settings = json.loads((root / "settings.json").read_text())
    DEVICE = settings["device"]
    inputs = np.load(root / "inputs.npz")
    x, s, t = inputs["x"], inputs["s"], inputs["t"]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
        smi = phase_device()
    else:       # a rehearsal on the CPU: nothing to synchronize
        smi = "cpu"
        torch.cuda.synchronize = torch.cuda.reset_peak_memory_stats = \
            lambda *a, **k: None
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/pg", world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=MULTIPROC_GROUP_TIMEOUT_S))
    rows = (np.arange(len(s), dtype=np.int32),
            np.arange(len(t), dtype=np.int32))
    sort = lambda **kw: (lambda pool: cluster.sort(
        x, device=DEVICE, substrate=pool, **kw))
    calls = {"multiproc_gloo_sort": (sort(), None),
             "multiproc_gloo_sort_ragged": (sort(backend="ragged"), sort()),
             "multiproc_gloo_sort_auto": (lambda pool: _fresh(
                 lambda: cluster.sort(x, algorithm="auto", seed=SEED,
                                      device=DEVICE, substrate=pool)), None),
             "multiproc_gloo_statjoin": (lambda pool: cluster.join(
                 s, rows[0], t, rows[1], algorithm="statjoin",
                 t_machines=settings["join_t"], device=DEVICE,
                 substrate=pool), None)}
    group, batch = SubstratePool(make=ProcessGroupSubstrate), SubstratePool()
    res = {"launches": {}, "ms": {}, "batch_ms": {}}
    try:
        for path, (run, twin) in calls.items():
            want = (twin or run)(batch)
            got = on_path(path, lambda: run(group))
            _same_run(f"{path} rank {rank}", got, want)
            del got, want
            res["launches"][path] = dict(PATH_LAUNCHES[path])
            res["ms"][path] = e2e(f"{path} rank {rank}", lambda: run(group),
                                  smi, reps=MULTIPROC_REPS)["ms"]
            if rank == 0:
                res["batch_ms"][path] = e2e(
                    f"{path} batch rank 0", lambda: (twin or run)(batch),
                    smi, reps=MULTIPROC_REPS)["ms"]
            dist.barrier()
            print(f"[multiproc] {path} rank {rank}/{world}: whole result "
                  f"bitwise this process's batch run; median "
                  f"{np.median(res['ms'][path]):.2f} ms", flush=True)
        res["host_staged_runs"] = group.stats().get("host_staged_runs", 0)
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(res))


def _same_profile(label: str, got, want) -> None:
    """A sketch profile of the card against the CPU's, field by field."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            _same_profile(label, a, b)
        elif isinstance(b, np.ndarray):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"{label}: profile field {f.name} differs from the CPU's")
        else:
            check(a == b, f"{label}: profile field {f.name} {a} != {b}")


def _same_plan(label: str, plan, plan_cpu) -> None:
    check((plan.algorithm, plan.exchange) == (plan_cpu.algorithm,
                                              plan_cpu.exchange)
          and dataclasses.asdict(plan.predicted)
          == dataclasses.asdict(plan_cpu.predicted),
          f"{label}: the card's plan differs from the CPU's")
    _same_profile(label, plan.profile, plan_cpu.profile)


def _ms_since(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_auto(smi: str) -> dict:
    """``algorithm="auto"`` at full size.  Sorts (``exchange="auto"``)
    on the uniform and Zipf t = 64 x 65,536 keys; joins on
    ``workloads.JOINS``' Zipf 2^17 x 2^17 and scalar-skew 2^20 tables at
    t = 64.  Each: the first call (the sketch round on the card, then
    the winner), its plan equal to the CPU's on the same input (the
    profile bitwise, so the same choice), the output equal to the call
    naming the winner, and a second call that hits the plan cache and
    runs no sketch; the planner alone cold and cached."""
    from repro_torch import planner
    out = {}
    inputs = sort_inputs(SEED)
    for name in ("uniform", "zipf"):
        x = inputs[name][0]
        path = f"sort_auto_{name}"
        kw = dict(seed=SEED, device=DEVICE)
        planner.clear_plan_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (keys, _), rep = on_path(path, lambda: cluster.sort(
            x, algorithm="auto", exchange="auto", **kw))
        first = _ms_since(t0)
        plan = rep.query_plan
        t0 = time.perf_counter()
        (keys2, _), rep2 = cluster.sort(x, algorithm="auto",
                                        exchange="auto", **kw)
        cached = _ms_since(t0)
        stats = planner.planner_stats()
        check(not plan.cached and rep2.query_plan.cached
              and stats["sketch_runs"] == 1 and stats["cache_hits"] == 1
              and rep2.sketch_phases == [] and same_bits(keys2, keys),
              f"{path}: the second call did not hit the plan cache: {stats}")
        (kw_keys, _), rep_w = cluster.sort(x, algorithm=plan.algorithm,
                                           exchange=plan.exchange, **kw)
        check(same_bits(keys, kw_keys)
              and rep.exchange_topology == rep_w.exchange_topology,
              f"{path}: output differs from the call naming the winner")
        _same_report(path, rep, rep_w)
        PATH_KERNELS[path] = SKETCH_KERNELS | PATH_KERNELS[
            TOPOLOGY_PATHS[(plan.algorithm, rep.exchange_topology)]]
        t0 = time.perf_counter()
        planner.plan_sort_query(x, t=T, device=DEVICE)   # cached
        plan_cached = _ms_since(t0)
        planner.clear_plan_cache()
        t0 = time.perf_counter()
        planner.plan_sort_query(x, t=T, device=DEVICE)
        plan_first = _ms_since(t0)
        planner.clear_plan_cache()
        plan_cpu, _ = planner.plan_sort_query(x, t=T, device="cpu")
        planner.clear_plan_cache()
        _same_plan(path, plan, plan_cpu)
        out[path] = {"algorithm": plan.algorithm, "exchange": plan.exchange,
                     "first_call_ms": first, "cached_call_ms": cached,
                     "plan_first_ms": plan_first,
                     "plan_cached_ms": plan_cached,
                     "predicted_k": rep.predicted_k,
                     "k_workload": rep.k_workload,
                     **plan_cache_costs(path, x, plan, kw, smi)}
        print(f"[auto] {path}: {plan.algorithm} / {plan.exchange} (the CPU's "
              f"plan, profile bitwise); predicted k {rep.predicted_k:.4f}, "
              f"measured {rep.k_workload:.4f}; first call {first:.2f} ms, "
              f"cached {cached:.2f} ms; the planner alone {plan_first:.2f} "
              f"ms cold, {plan_cached:.2f} ms cached ({smi})")
    for name in ("zipf", "scalar_skew"):
        s, t = JOINS[f"statjoin_{name}"].tables()
        s_rows = np.arange(len(s), dtype=np.int32)
        t_rows = np.arange(len(t), dtype=np.int32)
        path = f"join_auto_{name}"
        kw = dict(t_machines=JOIN_T, seed=SEED, device=DEVICE)
        planner.clear_plan_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, rep = on_path(path, lambda: cluster.join(
            s, s_rows, t, t_rows, algorithm="auto", **kw))
        first = _ms_since(t0)
        plan = rep.query_plan
        check_join(path, res, rep, host_pairs(s, t))
        t0 = time.perf_counter()
        res2, rep2 = cluster.join(s, s_rows, t, t_rows, algorithm="auto",
                                  **kw)
        cached = _ms_since(t0)
        stats = planner.planner_stats()
        check(rep2.query_plan.cached and stats["sketch_runs"] == 1
              and rep2.sketch_phases == [],
              f"{path}: the second call did not hit the plan cache: {stats}")
        sorts = []
        ops_sort_kv, ops_partition_kv = ops.sort_kv, ops.sort_partition_kv

        def tapped_sort_kv(keys, values, **k):
            sorts.append(("sort_kv", keys.shape[-1]))
            return ops_sort_kv(keys, values, **k)

        def tapped_partition_kv(keys, values, interior):
            sorts.append(("sort_partition_kv", keys.shape[-1]))
            return ops_partition_kv(keys, values, interior)

        ops.sort_kv, ops.sort_partition_kv = (tapped_sort_kv,
                                              tapped_partition_kv)
        try:
            res_w, rep_w = cluster.join(s, s_rows, t, t_rows,
                                        algorithm=plan.algorithm, **kw)
        finally:
            ops.sort_kv, ops.sort_partition_kv = (ops_sort_kv,
                                                  ops_partition_kv)
        for field in res._fields:
            check(same_bits(getattr(res, field), getattr(res_w, field))
                  and same_bits(getattr(res2, field), getattr(res, field)),
                  f"{path}: {field} differs from the call naming the winner")
        _same_report(path, rep, rep_w)
        PATH_KERNELS[path] = SKETCH_KERNELS | join_kernels(path, sorts)
        planner.clear_plan_cache()
        plan_cpu, _ = planner.plan_join_query(s, t, t_machines=JOIN_T,
                                              device="cpu")
        planner.clear_plan_cache()
        _same_plan(path, plan, plan_cpu)
        out[path] = {"algorithm": plan.algorithm, "first_call_ms": first,
                     "cached_call_ms": cached,
                     "predicted_k": rep.predicted_k,
                     "k_workload": rep.k_workload}
        print(f"[auto] {path}: {plan.algorithm} (the CPU's plan, profile "
              f"bitwise); predicted k {rep.predicted_k:.4f}, measured "
              f"{rep.k_workload:.4f}; first call {first:.2f} ms, cached "
              f"{cached:.2f} ms ({smi})")
        del res, res2, res_w
    return out


def plan_cache_costs(path: str, x, plan, kw: dict, smi: str) -> dict:
    """Does the plan cache pay on a sort?  Medians of 5, one after the
    other: the fingerprint alone of the rows on the card (its weighted
    sums there), one blake2b of the same bytes on the host (the
    fingerprint before), the plan with no cache (upload, sketch,
    scores), and three whole calls: the winner named, ``auto`` served
    from the cache, and ``auto`` with the cache bypassed (the uncached
    plan, then the winner on the rows it uploaded)."""
    import hashlib
    from repro_torch import planner
    from repro_torch.planner.plan import fingerprint_arrays, sketch_sort_plan
    extra = f"sort|t={T}|r=2"

    def bypassed():
        xt = torch.as_tensor(x).to(DEVICE)
        p, _ = sketch_sort_plan(xt, t=T)
        return cluster.sort(xt, algorithm=p.algorithm, exchange=p.exchange,
                            **kw)

    planner.plan_sort_query(x, t=T, device=DEVICE)          # warm the cache
    xt = torch.as_tensor(x).to(DEVICE)
    times = {
        "fingerprint_ms": e2e(f"{path} fingerprint of the rows on the "
                              f"card", lambda: fingerprint_arrays(
                                  xt, extra=extra), smi),
        "serial_blake2b_ms": e2e(f"{path} blake2b of the bytes on the host",
                                 lambda: hashlib.blake2b(
                                     np.ascontiguousarray(x).tobytes(),
                                     digest_size=16).hexdigest(), smi),
        "plan_uncached_ms": e2e(f"{path} plan with no cache",
                                lambda: sketch_sort_plan(
                                    torch.as_tensor(x).to(DEVICE), t=T),
                                smi),
        "named_call_ms": e2e(f"{path} {plan.algorithm} / {plan.exchange} "
                             f"named", lambda: cluster.sort(
                                 x, algorithm=plan.algorithm,
                                 exchange=plan.exchange, **kw), smi),
        "auto_cached_call_ms": e2e(f"{path} auto, cached", lambda:
                                   cluster.sort(x, algorithm="auto",
                                                exchange="auto", **kw), smi),
        "auto_bypassed_call_ms": e2e(f"{path} auto, cache bypassed",
                                     bypassed, smi),
    }
    planner.clear_plan_cache()
    return {k: v["median_ms"] for k, v in times.items()}


# ---------------------------------------------------------------------------
# serve_queries: the query-serving tier on the card
# ---------------------------------------------------------------------------

SERVE_TRACE_N = 64                  # requests in the trace
SERVE_CLASS_MIX = (0.1, 0.3, 0.6)   # high / normal / low, bench_serve.py's
SERVE_WORKERS = 4
SERVE_REPLICAS = 2
SERVE_WAIT_S = 300.0                # any one result, bounded
OVERLOAD_N = 96                     # small sorts in the burst
OVERLOAD_PENDING = 8                # its admission bound
OVERLOAD_RATE = 2.0                 # offered load over the sustained rate
# an execution's exec_s against its query's one-shot wall time: below
# this share the engine's clock stopped before the card was done
SERVE_EXEC_FLOOR = 0.5


def serve_specs() -> dict:
    """name -> the ten distinct queries of the serving trace: SMMS and
    Terasort on the uniform and Zipf t = 64 x 65,536 keys, SMMS with the
    24 x int32 payload, ``auto`` on the Zipf keys; StatJoin, RandJoin (8 x
    8) and ``auto`` on the Zipf 2^17 x 2^17 tables, broadcast on the Zipf
    2^14 x 2^17 ones, all at t = 64."""
    from repro_torch.serve import join_query, sort_query
    inputs = sort_inputs(SEED)
    xu, xz = inputs["uniform"][0], inputs["zipf"][0]
    specs = {
        "smms_uniform": sort_query(xu, algorithm="smms"),
        "smms_zipf": sort_query(xz, algorithm="smms"),
        "terasort_uniform": sort_query(xu, algorithm="terasort", seed=SEED),
        "terasort_zipf": sort_query(xz, algorithm="terasort", seed=SEED),
        "smms_records": sort_query(xu, algorithm="smms", values=make_payload(
            T, M, SEED, device=DEVICE)),
        "auto_zipf": sort_query(xz, algorithm="auto"),
    }
    for name, algorithm in (("statjoin_zipf", "statjoin"),
                            ("randjoin_zipf", "randjoin"),
                            ("auto_join_zipf", "auto"),
                            ("broadcast_zipf", "broadcast")):
        cfg = JOINS[name if algorithm != "auto" else "statjoin_zipf"]
        s, t = cfg.tables()
        s_rows = np.arange(len(s), dtype=np.int32)
        t_rows = np.arange(len(t), dtype=np.int32)
        kw = dict(cfg.options)
        if algorithm == "randjoin":
            kw.update(seed=SEED, ab=(8, 8))
        specs[name] = join_query(s, s_rows, t, t_rows, t_machines=JOIN_T,
                                 algorithm=algorithm, **kw)
    return specs


def serve_trace(specs: dict) -> list:
    """(name, spec) x SERVE_TRACE_N: each distinct query once, the rest
    a Zipf-weighted draw (the popularity skew of benchmarks/
    bench_serve.py's trace), shuffled; each request's class drawn from
    SERVE_CLASS_MIX."""
    rng = np.random.default_rng(SEED)
    names = list(specs)
    ranks = np.arange(1, len(names) + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    picks = list(range(len(names))) + list(
        rng.choice(len(names), SERVE_TRACE_N - len(names), p=p))
    picks = [picks[i] for i in rng.permutation(len(picks))]
    classes = rng.choice(3, len(picks), p=SERVE_CLASS_MIX)
    return [(names[i], dataclasses.replace(specs[names[i]], priority=int(c),
                                           tag=f"{names[i]}#{k}"))
            for k, (i, c) in enumerate(zip(picks, classes))]


def _value_tensors(value) -> list:
    return [v for v in value if v is not None]


def _same_result(label: str, res, want) -> None:
    """A served result against the one-shot call's: every tensor of the
    value bitwise (sort keys and values; every JoinOutput field), and the
    report's k_workload, k_network, alpha and capacity attempts."""
    check(res.ok, f"{label}: failed: {res.error}")
    value, rep = want
    check(len(res.value) == len(value)
          and all((a is None) == (b is None)
                  for a, b in zip(res.value, value))
          and all(same_bits(a, b) for a, b in zip(
              _value_tensors(res.value), _value_tensors(value))),
          f"{label}: value differs from the one-shot call's")
    for field in ("k_workload", "k_network", "alpha"):
        check(getattr(res.report, field) == getattr(rep, field),
              f"{label}: {field} differs from the one-shot call's")
    check(getattr(res.report, "capacity_attempts", None)
          == getattr(rep, "capacity_attempts", None),
          f"{label}: capacity attempts differ from the one-shot call's")


def _check_one_shot(name: str, spec, value, rep) -> None:
    """The one-shot results against the host: sorted keys equal to
    np.sort, the records in stable key order, join pairs equal to a
    host join."""
    if spec.kind == "sort":
        x = spec.arrays[0]
        keys, vals = value
        check(np.array_equal(keys.cpu().numpy().view(np.int32),
                             np.sort(x.reshape(-1)).view(np.int32)),
              f"serve {name}: keys differ from np.sort of the input")
        if vals is not None:
            order = torch.from_numpy(np.argsort(x.reshape(-1), kind="stable"))
            rows = spec.arrays[1].reshape(-1, PAYLOAD_COLS)
            check(torch.equal(vals, rows[order.to(rows.device)]),
                  f"serve {name}: records differ from the input's rows in "
                  f"stable key order")
    else:
        s, _, t, _ = spec.arrays
        check_join(f"serve {name}", value, rep, host_pairs(s, t))


def _serve_run(label: str, trace: list, want: dict, run, smi: str) -> dict:
    """One engine run of the trace on the path ``serve_queries``: every
    result equal to its query's one-shot result, the counts of
    executions, coalesced twins and result-cache hits adding up, each
    execution's ``exec_s`` at least half its one-shot call's wall
    time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats, extra = on_path("serve_queries", run)
    wall = time.perf_counter() - t0
    executed = 0
    for (name, _), res in zip(trace, results):
        _same_result(f"serve {label} {res.spec.tag}", res, want[name][:2])
        if not (res.coalesced or res.cached):
            executed += 1
            check(res.exec_s * 1e3 >= SERVE_EXEC_FLOOR * want[name][2],
                  f"serve {label} {res.spec.tag}: exec_s "
                  f"{res.exec_s * 1e3:.3f} ms under {SERVE_EXEC_FLOOR:g} x the "
                  f"one-shot "
                  f"call's {want[name][2]:.3f} ms: the clock stopped at the "
                  f"launch")
    n = len(trace)
    check(stats.served == n and stats.failed == 0
          and stats.executed == executed
          and stats.coalesced + stats.result_cache_hits == n - executed,
          f"serve {label}: served {stats.served}, executed "
          f"{stats.executed} ({executed} counted), coalesced "
          f"{stats.coalesced}, result-cache hits {stats.result_cache_hits} "
          f"of {n}")
    out = {"qps": n / wall, "wall_s": wall, "engine_qps": stats.qps,
           "executed": executed, "coalesced": stats.coalesced,
           "result_cache_hits": stats.result_cache_hits,
           "plan_cache_hits": stats.plan_cache_hits,
           "plan_cache_misses": stats.plan_cache_misses,
           "latency_by_class_ms": {
               cls: {q: v * 1e3 for q, v in lat.items()}
               for cls, lat in sorted(stats.latency_by_class.items())},
           "p50_ms": stats.p50_latency_s * 1e3,
           "p99_ms": stats.p99_latency_s * 1e3,
           "batches": stats.batches, **extra}
    lat = ", ".join(f"{cls} p50 {v['p50']:.2f} / p99 {v['p99']:.2f} ms"
                    for cls, v in out["latency_by_class_ms"].items())
    print(f"[serve] ({label}) {n} requests in {wall * 1e3:.1f} ms: "
          f"{out['qps']:.1f} QPS; executed {executed}, coalesced "
          f"{stats.coalesced}, result-cache hits {stats.result_cache_hits}, "
          f"plan-cache hits {stats.plan_cache_hits}; {lat}; every result "
          f"bitwise the one-shot call's ({smi})")
    del results
    return out


def _submit_from_threads(eng, trace: list, threads: int) -> list:
    """The trace from ``threads`` submitters, request i from thread
    i % threads; every thread joined within SERVE_WAIT_S."""
    results, errors = [None] * len(trace), []

    def submitter(k):
        try:
            tickets = [(i, eng.submit(trace[i][1]))
                       for i in range(k, len(trace), threads)]
            for i, tk in tickets:
                results[i] = tk.result(timeout=SERVE_WAIT_S)
        except Exception as exc:
            errors.append(exc)

    pool = [threading.Thread(target=submitter, args=(k,), daemon=True)
            for k in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=SERVE_WAIT_S)
        check(not th.is_alive(), "a submitter thread never finished")
    check(not errors, f"submitters raised {errors!r}")
    return results


def _prepare_ms(spec, smi: str) -> float:
    """Median of 5 of the engine's per-request upload and digest of one
    spec's operands (``serve.query._prepare``), synchronized."""
    from repro_torch.serve import query as serve_query
    dev = torch.device(DEVICE)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_query._prepare(spec, dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def phase_serve_queries(smi: str) -> dict:
    """The query-serving tier (``repro_torch.serve.QueryEngine``) on the
    card: the ten distinct queries of :func:`serve_specs` (a) one-shot
    through ``run_spec``, checked against the host, then the 64-request
    trace of :func:`serve_trace` (a) as a loop of one-shot calls, (b)
    through ``QueryEngine(workers=1)``, (c) through ``workers=4`` from 4
    submitter threads and (d) through ``EngineReplicas(2)`` sharing one
    pool and one result cache: every result of (b)-(d) bitwise the
    one-shot result of its query (keys, values, every join field;
    k_workload, k_network, alpha, capacity attempts), executions,
    coalesced twins and cache hits adding up to 64, and each
    execution's ``exec_s`` at least half the one-shot call's wall time.
    Then an overload burst of small sorts."""
    from repro_torch import planner
    from repro_torch.serve import EngineReplicas, QueryEngine, run_spec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    planner.clear_plan_cache()
    specs = serve_specs()
    trace = serve_trace(specs)
    # (a) each distinct query once: the one-shot results (the plan cache
    # then holds the auto queries' plans, as it does for the engines)
    torch.cuda.synchronize()
    cuda.reset_launches()
    one = {name: run_spec(spec, device=DEVICE)
           for name, spec in specs.items()}
    torch.cuda.synchronize()
    PATH_KERNELS["serve_queries"] = {k for k, n in cuda.LAUNCHES.items()
                                     if n > 0}
    for name, (value, rep) in one.items():
        _check_one_shot(name, specs[name], value, rep)
    # (a) the trace as a loop of one-shot calls, each synchronized
    walls = collections.defaultdict(list)
    t_loop = time.perf_counter()
    for name, spec in trace:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_spec(spec, device=DEVICE)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    loop_s = time.perf_counter() - t_loop
    want = {name: (*one[name], float(np.median(walls[name])))
            for name in specs}
    out = {"one_shot": {"qps": len(trace) / loop_s, "wall_s": loop_s,
                        "median_ms": {k: v[2] for k, v in want.items()},
                        "calls": {k: len(v) for k, v in walls.items()}}}
    print(f"[serve] (a) one-shot loop: {len(trace)} requests in "
          f"{loop_s * 1e3:.1f} ms, {out['one_shot']['qps']:.1f} QPS; "
          f"median ms a call: " + ", ".join(
              f"{k} {v[2]:.2f} (x{len(walls[k])})" for k, v in want.items())
          + f" ({smi})")
    out["prepare_ms"] = {name: _prepare_ms(specs[name], smi)
                         for name in ("smms_uniform", "smms_records",
                                      "statjoin_zipf")}
    print(f"[serve] the engine's upload + digest a request, median of 5: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out["prepare_ms"].items())
          + f" ({smi})")

    def single():
        with QueryEngine(max_batch=8, workers=1, device=DEVICE) as eng:
            res = eng.run([s for _, s in trace], timeout=SERVE_WAIT_S)
            torch.cuda.synchronize()
            return res, eng.stats(), {"cache_bytes": eng.results.nbytes()}

    def threaded():
        with QueryEngine(max_batch=8, workers=SERVE_WORKERS,
                         device=DEVICE) as eng:
            res = _submit_from_threads(eng, trace, SERVE_WORKERS)
            torch.cuda.synchronize()
            return res, eng.stats(), {"cache_bytes": eng.results.nbytes()}

    def replicas():
        with EngineReplicas(SERVE_REPLICAS, max_batch=8,
                            device=DEVICE) as fleet:
            check(fleet.engines[0].pool is fleet.engines[1].pool
                  and fleet.engines[0].results is fleet.engines[1].results,
                  "replicas do not share their pool and result cache")
            res = fleet.run([s for _, s in trace], timeout=SERVE_WAIT_S)
            torch.cuda.synchronize()
            stats = fleet.stats()
            # per class, the worst replica's (the fleet's own p50 / p99)
            for one in fleet.replica_stats():
                for cls, lat in one.latency_by_class.items():
                    mine = stats.latency_by_class.setdefault(cls, {})
                    for q, v in lat.items():
                        mine[q] = max(mine.get(q, 0.0), v)
            return res, stats, {
                "cache_bytes": fleet.results.nbytes(),
                "suggested_replicas": fleet.suggest_replicas()}

    out["single"] = _serve_run("b, workers=1", trace, want, single, smi)
    out["workers"] = _serve_run(f"c, workers={SERVE_WORKERS}", trace, want,
                                threaded, smi)
    out["replicas"] = _serve_run(f"d, EngineReplicas({SERVE_REPLICAS})",
                                 trace, want, replicas, smi)
    for key in ("single", "workers", "replicas"):
        print(f"[serve] ({key}) the result cache holds "
              f"{out[key]['cache_bytes']} bytes (operands and values) "
              f"after the trace")
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del one, want, specs, trace
    out["overload"] = serve_overload(smi)
    print(f"[serve] peak memory of the phase "
          f"{out['max_memory_allocated_bytes'] / 2**20:.1f} MiB; launches "
          f"on the path: {dict(PATH_LAUNCHES['serve_queries'])} ({smi})")
    return out


def serve_overload(smi: str) -> dict:
    """An overload burst of small SMMS sorts (t = 8 x 4,096, each its own
    keys): the rate one engine sustains on them, then OVERLOAD_N of them
    offered at OVERLOAD_RATE x that rate by one paced submitter, with
    ``max_pending=OVERLOAD_PENDING``, classes drawn from
    SERVE_CLASS_MIX and a deadline on the low class.  No high-class
    request is shed or rejected while a lower-class one is queued;
    every shed is a typed ``ShedError`` or ``DeadlineExceededError``;
    every served result is the one-shot call's."""
    from repro_torch.serve import (PRIORITY_HIGH, PRIORITY_LOW,
                                   AdmissionError, DeadlineExceededError,
                                   QueryEngine, ShedError, run_spec,
                                   sort_query)
    PATH_KERNELS["serve_overload"] = PATH_KERNELS[
        "small_sort" if cost_model_family(M_SMALL) == "bitonic"
        else "small_sort_radix"]
    rng = np.random.default_rng(SEED + 11)
    xs = [uniform_keys(T_SMALL * M_SMALL, seed=SEED + 100 + i)
          .reshape(T_SMALL, M_SMALL) for i in range(OVERLOAD_N + 16)]
    calib = [sort_query(x, algorithm="smms") for x in xs[OVERLOAD_N:]]
    with QueryEngine(max_batch=8, workers=1, device=DEVICE) as eng:
        eng.run(calib[:4], timeout=SERVE_WAIT_S)          # warm
        t0 = time.perf_counter()
        eng.run(calib[4:], timeout=SERVE_WAIT_S)
        sustained = len(calib[4:]) / (time.perf_counter() - t0)
        service = eng.metrics.histogram("serve_exec_seconds").mean
    classes = rng.choice(3, OVERLOAD_N, p=SERVE_CLASS_MIX)
    specs = [sort_query(x, algorithm="smms", priority=int(c),
                        tag=f"burst#{i}",
                        deadline_s=(20 * service if c == PRIORITY_LOW
                                    else None))
             for i, (x, c) in enumerate(zip(xs, classes))]
    interval = 1.0 / (OVERLOAD_RATE * sustained)
    outcome = collections.Counter()
    inversions = []

    def burst():
        tickets = []
        with QueryEngine(max_pending=OVERLOAD_PENDING, max_batch=8,
                         workers=1, device=DEVICE) as eng:
            start = time.perf_counter()
            for i, spec in enumerate(specs):
                delay = start + i * interval - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                try:
                    tickets.append((spec, eng.submit(spec, block=False)))
                except AdmissionError as exc:
                    check(not isinstance(exc, ShedError),
                          "a submit raised ShedError")
                    outcome[("rejected", spec.priority)] += 1
                    if spec.priority == PRIORITY_HIGH:
                        worse = {c: d for c, d in eng._admit.depths().items()
                                 if c > PRIORITY_HIGH}
                        if worse:
                            inversions.append((spec.tag, worse))
            results = []
            for spec, tk in tickets:
                try:
                    results.append((spec, tk.result(timeout=SERVE_WAIT_S)))
                    outcome[("served", spec.priority)] += 1
                except ShedError:
                    outcome[("shed", spec.priority)] += 1
                except DeadlineExceededError:
                    outcome[("expired", spec.priority)] += 1
            torch.cuda.synchronize()
            return results, eng.stats()

    results, stats = on_path("serve_overload", burst)
    check(not inversions, f"high-class submits rejected while lower-class "
                          f"requests were queued: {inversions}")
    check(outcome[("shed", PRIORITY_HIGH)] == 0
          and stats.shed_by_class.get("high", 0) == 0,
          "a high-class request was shed")
    shed = sum(n for (kind, _), n in outcome.items()
               if kind in ("shed", "expired"))
    refused = sum(n for (kind, _), n in outcome.items() if kind == "rejected")
    check(shed + refused > 0, f"the burst never overloaded the engine: "
                              f"{dict(outcome)}")
    check(shed == stats.shed + stats.expired
          and sum(outcome.values()) == OVERLOAD_N,
          f"sheds {shed} against the engine's {stats.shed} + "
          f"{stats.expired}; outcomes {dict(outcome)}")
    for spec, res in results:
        check(res.ok, f"{spec.tag}: failed: {res.error}")
    for spec, res in results[:8]:
        (keys, _), _ = run_spec(spec, device=DEVICE)
        check(same_bits(res.value[0], keys),
              f"{spec.tag}: keys differ from the one-shot call's")
    names = {0: "high", 1: "normal", 2: "low"}
    table = {names[c]: {kind: outcome[(kind, c)] for kind in
                        ("served", "shed", "expired", "rejected")}
             for c in range(3)}
    lat = {cls: {q: v * 1e3 for q, v in d.items()}
           for cls, d in stats.latency_by_class.items()}
    print(f"[serve] overload: {OVERLOAD_N} small sorts (t={T_SMALL} x "
          f"{M_SMALL}) offered at {OVERLOAD_RATE:g} x the sustained "
          f"{sustained:.1f} QPS (one every {interval * 1e3:.3f} ms), "
          f"max_pending={OVERLOAD_PENDING}: {table}; served latency ms "
          f"{lat}; no high-class request shed; every shed typed ({smi})")
    return {"sustained_qps": sustained, "offered_qps":
            OVERLOAD_RATE * sustained, "service_ms": service * 1e3,
            "by_class": table, "latency_by_class_ms": lat,
            "peak_pending": stats.peak_pending}


# ---------------------------------------------------------------------------
# 6c. the rest of the LM stack: the vision front end and the int8 KV
#     cache (pixtral-12b), Mamba-2 layers (mamba2-130m), the hybrid
#     (a jamba-1.5-large-398b cut); ROADMAP C18 on the card
# ---------------------------------------------------------------------------

# The smoke configurations run on the card against the CPU (phase 6's
# gemma3 check): (architecture, path, change to its smoke config)
SMOKE_VARIANTS = (
    (VLM_ARCH, "serve_pixtral_smoke", {}),
    (SSM_ARCH, "serve_mamba2_smoke", {}),
    (HYBRID_ARCH, "serve_jamba_smoke", {}),
    ("gemma-2b", "serve_gemma2b_int8_smoke", {"kv_quant": True}),
)
# The int8 cache against the bf16 one, both teacher-forced by the bf16
# run's tokens: the largest logit difference over the largest logit, and
# the share of argmaxes that agree -- the reference's own bounds
# (tests/test_models_smoke.py:test_int8_kv_cache_decode_parity)
INT8_REL_MAX, INT8_ARGMAX_AGREE = 0.05, 0.8
# The float64 recurrence against the card's chunked scan: the
# reference's own bound (tests/test_ssm_oracle.py)
SSD_ORACLE_TOL = 2e-4
# (B, S, H, P, N, chunk): a chunk that divides S and one that does not
SSD_ORACLE_SHAPES = ((2, 48, 3, 4, 8, 16), (2, 37, 3, 4, 8, 16))
# ROADMAP C18: machine counts whose float32 reciprocal rounds up
C18_SMMS, C18_TERASORT = (7, 1000), (7, 1024)


def layer_qkv(params, cfg, prompts: torch.Tensor, embeds) -> tuple:
    """The first attention layer's prefill q, k, v (B, H, S, hd), as the
    model hands them to ``attention`` (a prefill with the call tapped;
    its kernel launches are not on a path)."""
    box = []
    real = lm.attention

    def tap(q, k, v, **kw):
        if not box:
            box.append((q.contiguous(), k.contiguous(), v.contiguous()))
        return real(q, k, v, **kw)

    lm.attention = tap
    try:
        with torch.inference_mode():
            cache = lm.init_cache(cfg, prompts.shape[0], embeds.shape[1]
                                  + prompts.shape[1], device=DEVICE)
            lm.prefill(params, cfg, prompts, cache, embeds)
            del cache
    finally:
        lm.attention = real
    return box[0]


def flash_vs_blockwise(label: str, q, k, v, window=None,
                       fault_window=None) -> dict:
    """The flash kernel on bf16 q, k, v against the blockwise backend on
    the same values in float32 (the reference's default algorithm, no
    rounding of its scores), rounded to bf16 once: within FLASH_TOL's
    bf16 bound, one bf16 rounding apart.  With ``fault_window``, the
    blockwise result at that window must fall outside the bound (a
    window one key too wide, ROADMAP C9)."""
    rtol, atol = FLASH_TOL[torch.bfloat16]

    def blockwise(w):
        return attention(q.float(), k.float(), v.float(), causal=True,
                         window=w, backend="blockwise").to(q.dtype)

    got = fa.flash_attention(q, k, v, True, window)
    want = blockwise(window)
    err = max_abs_err(got, want)
    check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
          f"{label}: flash against blockwise, max abs err {err} outside "
          f"rtol {rtol} + atol {atol}")
    out = {"shape": [list(q.shape), list(k.shape)], "window": window,
           "max_abs_err": err, "bound": [rtol, atol]}
    msg = ""
    if fault_window is not None:
        wide = blockwise(fault_window)
        out["fault_window"] = fault_window
        out["fault_max_abs_err"] = max_abs_err(got, wide)
        check(not torch.allclose(got.float(), wide.float(), rtol=rtol,
                                 atol=atol),
              f"{label}: the bound does not reject a window of "
              f"{fault_window}")
        msg = (f"; against window {fault_window} (one key too wide) "
               f"{out['fault_max_abs_err']:.4g}, rejected")
        del wide
    print(f"[{label}] flash_attention {tuple(q.shape)} / {tuple(k.shape)} "
          f"bf16, window {window}, against the blockwise backend in f32: "
          f"max abs err {err:.4g} (bound rtol {rtol} + atol {atol}){msg}")
    return out


def phase_serve_pixtral(smi: str) -> dict:
    """``serve.generate`` for pixtral-12b at full width and depth (40
    layers, d_model 5120, 32 q / 8 kv heads of 128), bf16: B = 4 prompts
    of 2048 tokens after 256 front-end embeddings of 1024 (random, made
    on the card), 16 new tokens -- once with the bf16 KV cache, once
    with the int8 one (``kv_quant``), on the same weights.

    Checks, for each cache: the tokens; flash attention once per layer;
    the teacher-forced steps give generate's tokens; prefill against
    decode within SERVE_REL_L2 at SERVE_CHECK_STEPS.  The int8 cache
    against the bf16 one, teacher-forced by the bf16 tokens: the largest
    logit difference under INT8_REL_MAX of the largest logit, argmaxes
    agreeing on INT8_ARGMAX_AGREE.  The flash kernel against the
    blockwise backend on the first layer's prefill q, k, v (4, 32 / 8,
    2304, 128), and at gemma3-12b's window (4, 16 / 8, 2048, 256, window
    1024), where a window one key too wide must be rejected."""
    cfg = get_arch(VLM_ARCH)
    params, n_params, n_bytes, init_s = lm_params(cfg, "pixtral")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    embeds = torch.randn((SERVE_B, cfg.n_frontend_tokens, cfg.frontend_dim),
                         generator=gen, device=DEVICE)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    dev_prompts = torch.from_numpy(prompts).to(DEVICE)
    seq = cfg.n_frontend_tokens + SERVE_PROMPT + SERVE_NEW
    runs, logits = {}, {}
    for label, c in (("bf16", cfg),
                     ("int8", dataclasses.replace(cfg, kv_quant=True))):
        path = "serve_pixtral" + ("_int8" if c.kv_quant else "")
        tokens, gen_s, peak = served(path, params, c, prompts, SERVE_NEW,
                                     embeds)
        dev_tokens = torch.from_numpy(tokens).to(DEVICE)
        prefill_ms, step_ms, logits[label] = teacher_forced(
            params, c, dev_prompts, dev_tokens, path, embeds)
        errors, _ = prefill_vs_decode(params, c, dev_prompts, dev_tokens,
                                      logits[label], path, embeds)
        kv = cache_bytes(c, SERVE_B, seq)
        runs[label] = {"tokens_head": tokens[:, :6].tolist(),
                       "generate_first_call_s": gen_s,
                       "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                       "decode_step_median_ms": float(np.median(step_ms)),
                       "max_memory_allocated_bytes": peak,
                       "cache_bytes": kv, "prefill_vs_decode": errors}
        print(f"[{path}] generate {SERVE_B} x ({cfg.n_frontend_tokens} + "
              f"{SERVE_PROMPT}) + {SERVE_NEW}: {gen_s:.2f} s first call; "
              f"prefill {prefill_ms:.1f} ms, a decode step "
              f"{runs[label]['decode_step_median_ms']:.2f} ms (median of "
              f"{SERVE_NEW}; host clock + synchronize); KV cache "
              f"{ {n: f'{b / 1e6:.1f} MB' for n, b in kv.items()} }; peak "
              f"memory {peak / 2**30:.2f} GiB; tokens {tokens[:, :6].tolist()} "
              f"... ({smi})")
        if label == "bf16":
            bf16_tokens = dev_tokens
        else:
            # the int8 cache teacher-forced by the bf16 run's tokens
            _, _, quant = teacher_forced(params, c, dev_prompts, bf16_tokens,
                                         path, embeds, teacher=False)
            exact, quant = torch.stack(logits["bf16"]), torch.stack(quant)
            rel = float((exact - quant).abs().max() / exact.abs().max())
            agree = float((exact.argmax(-1) == quant.argmax(-1)).float()
                          .mean())
            runs["int8_vs_bf16"] = {"rel_max_err": rel, "argmax_agree": agree}
            print(f"[{path}] against the bf16 cache on the same tokens, "
                  f"{exact.shape[0]} x {SERVE_B} logit rows: largest "
                  f"difference {rel:.4g} of the largest logit (bound "
                  f"{INT8_REL_MAX}), argmax agrees on {agree:.3f} (bound "
                  f"{INT8_ARGMAX_AGREE})")
            check(rel < INT8_REL_MAX and agree >= INT8_ARGMAX_AGREE,
                  f"{path}: the int8 cache against the bf16 one: {rel}, "
                  f"{agree}")
            del exact, quant
    del logits
    q, k, v = layer_qkv(params, cfg, dev_prompts, embeds)
    runs["flash_vs_blockwise"] = flash_vs_blockwise("serve_pixtral", q, k, v)
    del q, k, v, params
    torch.cuda.empty_cache()
    g3 = get_arch(SERVE_ARCH)
    q, k, v = (torch.randn((SERVE_B, h, SERVE_PROMPT, g3.head_dim_),
                           generator=gen, device=DEVICE).bfloat16()
               for h in (g3.n_heads, g3.n_kv_heads, g3.n_kv_heads))
    runs["flash_vs_blockwise_window"] = flash_vs_blockwise(
        "serve_pixtral", q, k, v, g3.sliding_window, g3.sliding_window + 1)
    del q, k, v
    torch.cuda.empty_cache()
    return {"parameters": n_params, "parameter_bytes": n_bytes,
            "init_s": init_s, **runs}


def ssd_recurrence(x, dt, a_neg, b_in, c_in, d_skip) -> tuple:
    """The SSD as its step-by-step recurrence in float64 (numpy):
    h_t = exp(dt_t A) h_{t-1} + B_t dt_t x_t, y_t = C_t h_t + D x_t."""
    bsz, s, h, p = x.shape
    st = np.zeros((bsz, h, p, b_in.shape[-1]))
    ys = np.zeros((bsz, s, h, p))
    for t in range(s):
        st = (st * np.exp(dt[:, t] * a_neg)[:, :, None, None]
              + (x[:, t] * dt[:, t][..., None])[..., None]
              * b_in[:, t][:, None, None, :])
        ys[:, t] = (np.einsum("bn,bhpn->bhp", c_in[:, t], st)
                    + x[:, t] * d_skip[None, :, None])
    return ys, st


def ssd_oracle() -> dict:
    """``ssd_chunked`` on the card (float32) against the float64
    recurrence, at a chunk that divides the length and one that does
    not, within SSD_ORACLE_TOL."""
    rng = np.random.default_rng(SEED)
    out = {}
    for b, s, h, p, n, chunk in SSD_ORACLE_SHAPES:
        x = rng.standard_normal((b, s, h, p))
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
        b_in, c_in = (rng.standard_normal((b, s, n)) for _ in range(2))
        a_neg = -np.exp(np.linspace(0.0, 1.5, h))
        d_skip = np.linspace(0.5, 1.5, h)
        args = [torch.from_numpy(z).float().to(DEVICE)
                for z in (x, dt, a_neg, b_in, c_in, d_skip)]
        y, st = ssd_chunked(*args, chunk)
        # the recurrence on the float32 inputs the card saw
        y_ref, st_ref = ssd_recurrence(*(a.double().cpu().numpy()
                                         for a in args))
        err = max(float(np.abs(y.double().cpu().numpy() - y_ref).max()),
                  float(np.abs(st.double().cpu().numpy() - st_ref).max()))
        ok = (np.allclose(y.cpu().numpy(), y_ref, rtol=SSD_ORACLE_TOL,
                          atol=SSD_ORACLE_TOL)
              and np.allclose(st.cpu().numpy(), st_ref, rtol=SSD_ORACLE_TOL,
                              atol=SSD_ORACLE_TOL))
        check(ok, f"ssd_chunked {(b, s, h, p, n)} chunk {chunk} on the card: "
                  f"max abs err {err} against the float64 recurrence")
        out[f"{(b, s, h, p, n)} chunk {chunk}"] = err
    print(f"[serve_mamba2] ssd_chunked on the card against the float64 "
          f"recurrence: max abs err {out} (bound rtol = atol = "
          f"{SSD_ORACLE_TOL})")
    return out


def phase_serve_mamba2(smi: str) -> dict:
    """``serve.generate`` for mamba2-130m at full width and depth (24
    Mamba-2 layers, d_model 768, d_inner 1536, 16 heads of 96, d_state
    128, chunk 256, tied embeddings), bf16: B = 4 prompts of 2048 tokens,
    16 new tokens, nothing cut; and one prompt of 32,768 tokens (128
    chunks), prefill only.  No hand kernel is on this path: the SSD scan
    is torch ops, as the reference's is jnp.

    Checks: the tokens; no kernel launched; the teacher-forced steps;
    prefill against decode within SERVE_REL_L2; the long prompt's logits
    finite, and a prefill over its first 32,767 tokens then a decode
    step of the last within SERVE_REL_L2 of them; ``ssd_chunked`` on the
    card against the float64 recurrence (:func:`ssd_oracle`)."""
    cfg = get_arch(SSM_ARCH)
    params, n_params, n_bytes, init_s = lm_params(cfg, "serve_mamba2")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    tokens, gen_s, peak = served("serve_mamba2", params, cfg, prompts,
                                 SERVE_NEW)
    check(not +PATH_LAUNCHES["serve_mamba2"],
          f"serve_mamba2 launched {dict(PATH_LAUNCHES['serve_mamba2'])}")
    print("[serve_mamba2] generate launched no hand kernel (none is on an "
          "attention-free path)")
    dev_prompts = torch.from_numpy(prompts).to(DEVICE)
    dev_tokens = torch.from_numpy(tokens).to(DEVICE)
    prefill_ms, step_ms, logits = teacher_forced(
        params, cfg, dev_prompts, dev_tokens, "serve_mamba2")
    errors, _ = prefill_vs_decode(params, cfg, dev_prompts, dev_tokens,
                                  logits, "serve_mamba2")
    del logits
    kv = cache_bytes(cfg, SERVE_B, SERVE_PROMPT + SERVE_NEW)
    decode_ms = float(np.median(step_ms))
    print(f"[serve_mamba2] generate {SERVE_B} x {SERVE_PROMPT} + {SERVE_NEW}: "
          f"{gen_s:.2f} s first call; prefill {prefill_ms:.1f} ms, a decode "
          f"step {decode_ms:.2f} ms (median of {SERVE_NEW}; host clock + "
          f"synchronize); state {kv}; peak memory {peak / 2**30:.2f} GiB; "
          f"tokens {tokens[:, :6].tolist()} ... ({smi})")

    long = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (1, SSM_LONG_PROMPT)).astype(np.int32)).to(DEVICE)
    with torch.inference_mode():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = lm.init_cache(cfg, 1, SSM_LONG_PROMPT, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, cache = on_path("serve_mamba2_long", lambda: lm.prefill(
            params, cfg, long, cache))
        long_ms = (time.perf_counter() - t0) * 1e3
        long_peak = torch.cuda.max_memory_allocated()
        want = want[:, :cfg.vocab_size].float()
        check(bool(torch.isfinite(want).all()),
              "serve_mamba2: the long prompt's logits are not finite")
        cache = lm.init_cache(cfg, 1, SSM_LONG_PROMPT, device=DEVICE)
        _, cache = lm.prefill(params, cfg, long[:, :-1], cache)
        got, cache = lm.decode_step(params, cfg, long[:, -1:], cache)
        del cache
        long_err = rel_l2(got[:, :cfg.vocab_size].float(), want)
    print(f"[serve_mamba2] one prompt of {SSM_LONG_PROMPT} tokens "
          f"({SSM_LONG_PROMPT // cfg.ssm.chunk} chunks): prefill {long_ms:.1f} "
          f"ms (host clock + synchronize), peak memory "
          f"{long_peak / 2**30:.2f} GiB; a prefill of the first "
          f"{SSM_LONG_PROMPT - 1} and a decode step of the last give its "
          f"logits within relative L2 {long_err:.4g} (bound {SERVE_REL_L2}) "
          f"({smi})")
    check(long_err <= SERVE_REL_L2,
          f"serve_mamba2: long prompt, prefill vs decode {long_err}")
    oracle = ssd_oracle()
    del params
    torch.cuda.empty_cache()
    return {"parameters": n_params, "parameter_bytes": n_bytes,
            "init_s": init_s, "generate_first_call_s": gen_s,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "decode_step_median_ms": decode_ms,
            "max_memory_allocated_bytes": peak, "state_bytes": kv,
            "prefill_vs_decode": errors,
            "long_prompt": {"tokens": SSM_LONG_PROMPT, "prefill_ms": long_ms,
                            "max_memory_allocated_bytes": long_peak,
                            "prefill_vs_decode_rel_l2": long_err},
            "ssd_oracle_max_abs_err": oracle}


def hybrid_peak_bytes(cfg, n_bytes: int) -> int:
    """The jamba cut's peak, worked out before the run: its weights, and
    the dense alpha_k dispatch's gathered slot weights (every slot's
    three matrices at once, ``models/moe.py:moe_layer``), plus 1 GiB for
    the activations, the cache and the logits."""
    moe = cfg.moe
    slots = moe.num_experts + moe.extra_slots
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    return (n_bytes + slots * 3 * cfg.d_model * moe.d_ff_expert * itemsize
            + 2**30)


def phase_serve_jamba(smi: str) -> dict:
    """``serve.generate`` for jamba-1.5-large-398b at full width, its
    depth cut to one period of two (:func:`workloads.hybrid_cut`):
    attention (64 q / 8 kv heads of 128) with the dense SwiGLU FFN of
    24,576, then a Mamba-2 mixer (d_inner 16,384, 128 heads of 128,
    d_state 128) with the MoE (16 experts of 24,576, top-2, alpha_k, 16
    extra slots); bf16; one prompt of 1024 tokens, 8 new tokens.  The
    peak is worked out before the run (:func:`hybrid_peak_bytes`) and
    must fit the card.

    Checks: the tokens; flash attention once; the teacher-forced steps;
    prefill against decode within SERVE_REL_L2 on the steps whose last
    position neither run dropped or routed to other experts
    (:func:`moe_prefill_vs_decode`, ``moe_last``), on at least one
    step."""
    cfg = hybrid_cut(get_arch(HYBRID_ARCH))
    n_bytes = 2 * cfg.param_count()
    predicted = hybrid_peak_bytes(cfg, n_bytes)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[serve_jamba] predicted peak {predicted / 2**30:.2f} GiB of the "
          f"card's {total / 2**30:.2f}: {n_bytes / 1e9:.2f} GB of weights "
          f"and the alpha_k dispatch's gathered slot weights")
    check(predicted < total, f"serve_jamba: predicted peak {predicted} "
                             f"bytes past the card's {total}")
    params, n_params, n_bytes, init_s = lm_params(cfg, "serve_jamba")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (HYBRID_B, HYBRID_PROMPT)).astype(np.int32)
    tokens, gen_s, peak = served("serve_jamba", params, cfg, prompts,
                                 HYBRID_NEW)
    with torch.inference_mode():
        res = moe_prefill_vs_decode(
            params, cfg, torch.from_numpy(prompts).to(DEVICE),
            torch.from_numpy(tokens).to(DEVICE), "serve_jamba bf16",
            teacher=True, moe_last=True)
    check(res["checked"], "serve_jamba: every step dropped or routed apart; "
                          "the prefill-vs-decode check held nowhere")
    decode_ms = float(np.median(res["decode_step_ms"]))
    kv = cache_bytes(cfg, HYBRID_B, HYBRID_PROMPT + HYBRID_NEW)
    print(f"[serve_jamba] generate {HYBRID_B} x {HYBRID_PROMPT} + "
          f"{HYBRID_NEW}: {gen_s:.2f} s first call; prefill "
          f"{res['prefill_ms']:.1f} ms, a decode step {decode_ms:.2f} ms "
          f"(median of {HYBRID_NEW}; host clock + synchronize); cache {kv}; "
          f"peak memory {peak / 2**30:.2f} GiB (predicted "
          f"{predicted / 2**30:.2f}); prefill drops by MoE layer "
          f"{res['prefill_dropped_by_layer']}; tokens {tokens.tolist()} "
          f"({smi})")
    del params
    torch.cuda.empty_cache()
    return {"parameters": n_params, "parameter_bytes": n_bytes,
            "init_s": init_s, "generate_first_call_s": gen_s,
            "decode_step_median_ms": decode_ms,
            "max_memory_allocated_bytes": peak,
            "predicted_peak_bytes": predicted, "cache_bytes": kv, **res}


def c18_moved(count: int, num: int, den: int) -> int:
    """How many of the indices ceil(j num / den), j = 1..count, XLA's
    float32(j num) x float32(1/den) moves off the exact quotient's."""
    j = np.arange(1, count + 1, dtype=np.int64)
    xla = np.ceil((j * num).astype(np.float32)
                  * (np.float32(1) / np.float32(den)))
    return int((xla != -(-j * num // den)).sum())


def phase_c18() -> None:
    """ROADMAP C18 on the card: SMMS at t=7 x 1,000 and Terasort at t=7
    x 1,024 (its draws made from SEED with numpy, handed to both runs),
    where the reference's jitted index arithmetic -- float32(j m) x
    float32(1/s) -- takes samples one later than an exact division
    would (SMMS's last one past the row: a NaN boundary).  Keys,
    boundaries (NaN by NaN-ness: the card's NaN bits are its own),
    workload and every report field equal to the CPU run."""
    (t, m), (tt, mt) = C18_SMMS, C18_TERASORT
    x = np.random.default_rng(SEED).uniform(-1e3, 1e3, (t, m)).astype(
        np.float32)
    xt = uniform_keys(tt * mt, seed=SEED).reshape(tt, mt)
    u = torch.from_numpy(np.random.default_rng(SEED).random(
        (tt, mt), dtype=np.float32))
    moved = {"c18_smms": c18_moved(2 * t, m, 2 * t),
             "c18_terasort": c18_moved(
                 tt - 1, tt * terasort_sample_count(tt * mt, tt), tt)}
    check(all(moved.values()), f"C18: no index moved at these sizes {moved}")
    nans = {}
    for path, algorithm, keys_in, kw in (
            ("c18_smms", "smms", x, {}),
            ("c18_terasort", "terasort", xt, {"uniforms": u})):
        (keys, _), rep = on_path(path, lambda: cluster.sort(
            keys_in, algorithm=algorithm, device=DEVICE, **kw))
        (keys_cpu, _), rep_cpu = cluster.sort(keys_in, algorithm=algorithm,
                                              device="cpu", **kw)
        check(same_bits(keys, keys_cpu), f"{path}: card keys != CPU keys")
        b, b_cpu = rep.boundaries, rep_cpu.boundaries
        nan = np.isnan(b_cpu)
        check(np.array_equal(np.isnan(b), nan) and np.array_equal(
            b[~nan].view(np.int32), b_cpu[~nan].view(np.int32)),
            f"{path}: card boundaries != CPU boundaries")
        _same_report(path, rep, rep_cpu)
        nans[path] = int(nan.sum())
    print(f"[small] C18: SMMS t={t} m={m} and Terasort t={tt} m={mt}, "
          f"indices moved by the float32 reciprocal {moved}, NaN boundaries "
          f"{nans}: the card's keys, boundaries, workload and every report "
          f"field equal the CPU run")


# ---------------------------------------------------------------------------
# 6c. training: gemma-2b and mamba2-130m train on the card
# ---------------------------------------------------------------------------

# (arch, path): the float32 smoke configurations trained on the card
# against the CPU
TRAIN_SMOKE = (("gemma-2b", "train_gemma2b_smoke"),
               (MOE_ARCH, "train_granite_smoke"),
               (SSM_ARCH, "train_mamba2_smoke"),
               (VLM_ARCH, "train_pixtral_smoke"))
# Card against CPU, float32 (TF32 off): the loss within rtol 1e-5, and
# each gradient leaf's largest error within 1e-3 of the leaf's largest
# magnitude.  The two sum in other orders (cuBLAS against the CPU's
# GEMMs, the flash kernel against its plain version in the forward),
# ~1e-6 a value before the backward pass compounds it over a few
# layers; 1e-3 leaves room for that and still sees a wrong or missing
# term (each is O(1) of the leaf).
TRAIN_SMOKE_LOSS_RTOL, TRAIN_SMOKE_GRAD_TOL = 1e-5, 1e-3
# The resumed run's losses against the uninterrupted run's, both on the
# card: the reference's own bound (tests/test_train_e2e.py)
TRAIN_RESUME_TOL = dict(rtol=1e-5, atol=1e-6)
# FlashAttentionFn against autograd through the blockwise backend: the
# forward is the kernel (FLASH_TOL against the blockwise scan); the
# backward recomputes that same scan, so its gradients are expected
# bitwise, bounded by FLASH_TOL all the same
FLASH_GRAD_SHAPES = (("gemma-2b", None), (SERVE_ARCH, "window"))


def loss_and_grads(params, cfg, batch: dict, remat: str = "full") -> tuple:
    """train_loss and the gradient of every leaf, by autograd."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.train_loss(params, cfg, batch, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def smoke_batch(cfg, b: int = 2, s: int = 48) -> dict:
    """A numpy-seeded batch (-1 labels on row 0's first three positions;
    vision embeds where the config has them) as CPU tensors."""
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def attention_layers(cfg) -> int:
    return cfg.n_periods * sum(cfg.kind(p) != "mamba"
                               for p in range(cfg.period))


def phase_train_smoke() -> dict:
    """The four smoke configurations' loss and every gradient leaf on
    the card against the CPU (the same weights and batch; remat
    "full": the flash kernel in each attention layer's forward and again
    in its recompute), then ``train`` on the card for 30 steps of
    gemma-2b's smoke config (d_model 64, vocab 512: the reference's
    tests/test_train_e2e.py), checkpoints every 10; a run of 20 and a
    resume to 30 reproduce the uninterrupted run's last 10 losses."""
    out = {}
    for arch, path in TRAIN_SMOKE:
        cfg = smoke_config(get_arch(arch))
        params = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu")
        on_card = tree_map(lambda w: w.to(DEVICE), params)
        batch = smoke_batch(cfg)
        loss_cpu, grads_cpu = loss_and_grads(params, cfg, batch)
        card_batch = {k: v.to(DEVICE) for k, v in batch.items()}
        loss, grads = on_path(path, lambda: loss_and_grads(
            on_card, cfg, card_batch))
        loss_err = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
        worst = max(max_abs_err(g, c) / max(float(c.abs().max()), 1e-30)
                    for g, c in zip(grads, grads_cpu))
        check(loss_err <= TRAIN_SMOKE_LOSS_RTOL,
              f"{path}: loss {float(loss)} against the CPU's "
              f"{float(loss_cpu)}")
        check(worst <= TRAIN_SMOKE_GRAD_TOL,
              f"{path}: a gradient leaf differs from the CPU's by {worst} "
              f"of its largest magnitude")
        want = 2 * attention_layers(cfg)
        got = PATH_LAUNCHES[path]["flash_attention"]
        check(got == want, f"{path}: {got} flash_attention launches, want "
                           f"{want} (each attention layer's forward and "
                           f"its recompute)")
        print(f"[train_smoke] {cfg.name}: loss {float(loss):.6f} on the "
              f"card, {loss_err:.3g} from the CPU's (rtol "
              f"{TRAIN_SMOKE_LOSS_RTOL}); {len(grads)} gradient leaves, the "
              f"worst {worst:.3g} of its largest magnitude from the CPU's "
              f"(bound {TRAIN_SMOKE_GRAD_TOL}); flash launches {got}")
        out[path] = {"loss_rel_err": loss_err, "grad_rel_err": worst,
                     "flash_launches": got}

    cfg = dataclasses.replace(smoke_config(get_arch("gemma-2b")),
                              vocab_size=512, d_model=64)
    kw = dict(batch=4, seq=32, lr=3e-3, ckpt_every=10, log_every=1000,
              device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        full = train(cfg, 30, ckpt_dir=f"{tmp}/a", **kw)
        train(cfg, 20, ckpt_dir=f"{tmp}/b", **kw)
        resumed = on_path("train_resume", lambda: train(
            cfg, 30, ckpt_dir=f"{tmp}/b", **kw))
    diff = float(np.max(np.abs(np.asarray(resumed) - np.asarray(full[20:]))))
    check(len(resumed) == 10 and np.allclose(resumed, full[20:],
                                             **TRAIN_RESUME_TOL),
          f"train_resume: resumed losses {resumed} against {full[20:]}")
    check(np.mean(full[-5:]) < np.mean(full[:5]),
          f"train_resume: the loss did not fall {full[:5]} ... {full[-5:]}")
    print(f"[train_smoke] train 30 steps on the card, {full[0]:.4f} -> "
          f"{full[-1]:.4f}; 20 steps, then a resume from the step-20 "
          f"checkpoint to 30: the last 10 losses within {diff:.3g} of the "
          f"uninterrupted run's (bound rtol {TRAIN_RESUME_TOL['rtol']} + "
          f"atol {TRAIN_RESUME_TOL['atol']}; "
          f"{'bitwise' if diff == 0 else 'not bitwise'})")
    out["train_resume"] = {"losses": full, "resumed": resumed,
                           "max_abs_diff": diff}
    return out


def phase_flash_grad() -> dict:
    """``attention`` under autograd -- FlashAttentionFn: the kernel
    forward, the blockwise recompute backward -- against autograd
    through ``backend="blockwise"`` on the same q, k, v and upstream
    gradient: at gemma-2b's training shape (4 x 8 q / 1 kv head of 256,
    S = 2048) and gemma3-12b's local layers (4 x 16 / 8 heads of 256,
    window 1024), f32 and bf16.  The output within FLASH_TOL of the
    blockwise scan's on the same values in float32 rounded once (as
    :func:`flash_vs_blockwise`: the bf16 scan rounds its scores), dq /
    dk / dv within FLASH_TOL of autograd's."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for arch, window in FLASH_GRAD_SHAPES:
        cfg = get_arch(arch)
        w = cfg.sliding_window if window else None
        for dtype in (torch.float32, torch.bfloat16):
            label = (f"{arch}{' window ' + str(w) if w else ''} "
                     f"{str(dtype)[6:]}")
            shapes = ((TRAIN_B, cfg.n_heads, TRAIN_SEQ, cfg.head_dim_),
                      (TRAIN_B, cfg.n_kv_heads, TRAIN_SEQ, cfg.head_dim_))
            q, k, v = (torch.randn(shapes[i > 0], generator=gen,
                                   device=DEVICE).to(dtype).requires_grad_()
                       for i in range(3))
            dout = torch.randn(shapes[0], generator=gen,
                               device=DEVICE).to(dtype)
            got = on_path("flash_grad", lambda: attention(q, k, v, window=w))
            grads = torch.autograd.grad(got, (q, k, v), dout)
            want = attention(q, k, v, window=w, backend="blockwise")
            want_grads = torch.autograd.grad(want, (q, k, v), dout)
            with torch.no_grad():       # the forward: as flash_vs_blockwise
                ref = attention(q.float(), k.float(), v.float(), window=w,
                                backend="blockwise").to(dtype)
            rtol, atol = FLASH_TOL[dtype]
            errs = [max_abs_err(got.detach(), ref)]
            ok = torch.allclose(got.float(), ref.float(), rtol=rtol,
                                atol=atol)
            for g, wg in zip(grads, want_grads):
                errs.append(max_abs_err(g, wg))
                ok = ok and torch.allclose(g.float(), wg.float(), rtol=rtol,
                                           atol=atol)
            check(ok, f"flash_grad {label}: out / dq / dk / dv max abs err "
                      f"{errs} outside rtol {rtol} + atol {atol}")
            print(f"[flash_grad] {label}: out (kernel vs blockwise) "
                  f"{errs[0]:.4g}, dq {errs[1]:.4g}, dk {errs[2]:.4g}, dv "
                  f"{errs[3]:.4g} against autograd through the blockwise "
                  f"backend (bound rtol {rtol} + atol {atol})")
            out[label] = errs
            del q, k, v, dout, got, grads, want, want_grads, ref
    launched = PATH_LAUNCHES["flash_grad"]["flash_attention"]
    check(launched == 2 * len(FLASH_GRAD_SHAPES),      # two dtypes a shape
          f"flash_grad: {launched} kernel launches, want one a forward")
    torch.cuda.empty_cache()
    return out


def train_state_bytes(cfg, adamw_cfg) -> dict:
    """The training state worked out from the shapes: weights and
    gradients in the parameters' dtypes, two moments in the moment
    dtype."""
    shapes = tree_leaves(lm.params_shape(cfg))
    weights = sum(p.numel() * p.element_size() for p in shapes)
    moment = torch.empty((), dtype=adamw_cfg.moment_dtype).element_size()
    return {"weights": weights, "gradients": weights,
            "moments": 2 * sum(p.numel() for p in shapes) * moment,
            "largest_leaf": max(p.numel() for p in shapes)}


def phase_train(smi: str, arch: str, path: str, batch: int,
                n_steps: int) -> dict:
    """``arch`` at its published width and depth (bf16 weights made on
    the card from SEED, float32 AdamW moments, remat "full", the cosine
    schedule at TRAIN_LR with TRAIN_WARMUP warm-up steps) through
    ``launch.steps.build_train_step`` on ``data.TokenPipeline``'s
    batches, ``batch`` x TRAIN_SEQ tokens a step, ``n_steps`` steps, the
    first a warm-up.  Each step's host-clock time ends in a synchronize.
    Checks: the losses finite, the mean of the last three below the
    first; the flash kernel twice a step in every attention layer (the
    forward and remat's recompute), no other kernel.  Prints the median
    step, tok/s, model_flops over the step time over the bf16 peak, the
    peak memory beside the state worked out from the shapes."""
    cfg = get_arch(arch)
    shape = ShapeSpec(path, "train", TRAIN_SEQ, batch)
    adamw_cfg = AdamWConfig(lr=TRAIN_LR)
    state = train_state_bytes(cfg, adamw_cfg)
    state_total = state["weights"] + state["gradients"] + state["moments"]
    print(f"[{path}] worked out before the run: weights "
          f"{state['weights'] / 1e9:.2f} GB, gradients "
          f"{state['gradients'] / 1e9:.2f} GB, moments "
          f"{state['moments'] / 1e9:.2f} GB; the largest leaf "
          f"{state['largest_leaf'] / 1e6:.1f} M values")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, n_params, n_bytes, init_s = lm_params(cfg, path)
    bundle = build_train_step(
        cfg, None, shape, remat="full", adamw=adamw_cfg,
        lr_schedule=lambda s: cosine_schedule(s, TRAIN_LR, TRAIN_WARMUP,
                                              n_steps))
    opt = adamw_init(params, adamw_cfg)
    pipe = TokenPipeline(cfg.vocab_size, batch, TRAIN_SEQ, seed=SEED)
    losses, step_ms, flash = [], [], []
    for step in range(n_steps):
        data = batch_on(pipe.batch_at(step), DEVICE)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, metrics = on_path(path, lambda: bundle.fn(
            params, opt, data))
        step_ms.append((time.monotonic() - t0) * 1e3)
        flash.append(cuda.LAUNCHES["flash_attention"])
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms[1:]))
    tok_s = batch * TRAIN_SEQ / (median / 1e3)
    flops = roofline.model_flops(cfg, shape)
    share = flops / (median / 1e3) / roofline.PEAK_FLOPS
    want = 2 * attention_layers(cfg)
    check(all(math.isfinite(x) for x in losses),
          f"{path}: losses not finite {losses}")
    check(np.mean(losses[-3:]) < losses[0],
          f"{path}: the mean of the last three losses {losses[-3:]} is not "
          f"below the first {losses[0]}")
    check(all(n == want for n in flash),
          f"{path}: flash launches a step {flash}, want {want}")
    print(f"[{path}] {cfg.name} trains {n_steps} steps of {batch} x "
          f"{TRAIN_SEQ} tokens: losses {[round(x, 4) for x in losses]}; a "
          f"step {median:.1f} ms (median of steps 2-{n_steps}; the first "
          f"{step_ms[0]:.1f}), {tok_s:.0f} tok/s, model_flops "
          f"{flops / 1e12:.1f} TFLOP a step = {share:.4f} of the bf16 peak "
          f"({roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB; state worked out "
          f"{state_total / 1e9:.2f} GB); flash launches a step {flash[-1]} "
          f"({smi})")
    del params, opt, bundle, metrics
    torch.cuda.empty_cache()
    return {"parameters": n_params, "parameter_bytes": n_bytes,
            "init_s": init_s, "losses": losses, "step_ms": step_ms,
            "step_median_ms": median, "tokens_per_s": tok_s,
            "model_flops": flops, "bf16_peak_share": share,
            "max_memory_allocated_bytes": peak, "state_bytes": state,
            "flash_launches_per_step": flash[-1]}


# ---------------------------------------------------------------------------
# mesh: the model half of the process-group substrate (ROADMAP A7)
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3
# train_gemma2b's median step and peak memory without a mesh, first
# measured on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md), printed beside
# this run's
NO_MESH_STEP_MS, NO_MESH_PEAK_GB = 887.7, 37.70
DRYRUN_CELLS = (("gemma-2b", "train_4k"), ("gemma3-12b", "decode_32k"))
DRYRUN_WAIT_S = 600


class _StandInMesh:
    """The production (16, 16) mesh as the rules read it: its shape and
    axis names, no ranks."""
    shape, axis_names = (16, 16), ("data", "model")


def spec_argument_bytes(cfg, shape_name: str) -> int:
    """One device's argument bytes of the step on (16, 16), worked out
    from the rules' specs and the leaves' shapes alone: the parameters,
    and the moments, step and batch (train) or the tokens and the cache
    (serving)."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.shapes import input_specs
    from repro_torch.sharding.specs import local_shape, make_rules
    mesh = _StandInMesh()
    rules = make_rules(mesh, cfg)
    shape = SHAPES[shape_name]

    def tree_bytes(tree, specs, itemsize=None) -> int:
        if isinstance(tree, dict):
            return sum(tree_bytes(tree[k], specs[k], itemsize) for k in tree)
        if isinstance(tree, list):
            return sum(tree_bytes(v, sp, itemsize)
                       for v, sp in zip(tree, specs))
        if not isinstance(tree, torch.Tensor):
            return 0
        return math.prod(local_shape(tree.shape, specs, mesh)) * (
            itemsize or tree.element_size())

    pshape = lm.params_shape(cfg)
    pspecs = rules.param_specs(pshape)
    total = tree_bytes(pshape, pspecs)
    specs = input_specs(cfg, shape)
    batch = lambda t: tree_bytes(t, rules.batch_spec(t.shape[0]))  # noqa
    if shape.kind == "train":
        return (total + 2 * tree_bytes(pshape, pspecs, 4) + 4
                + batch(specs["tokens"]) + batch(specs["labels"]))
    return (total + batch(specs["token" if shape.kind == "decode"
                                else "tokens"])
            + tree_bytes(specs["cache"], rules.cache_specs(specs["cache"])))


def start_dryruns(out_dir: str) -> list:
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS,
    started now in the background (the CPU traces them while the card
    runs the other phases)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(pathlib.Path(out_dir) / f"{arch}_{shape}.log", "w")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out_dir],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))))

    def stop():                 # a failed phase leaves none running
        for _, _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    return procs


def collect_dryruns(procs: list, out_dir: str, smi: str) -> dict:
    """Each dry run's record: ``ok``, and its per-device arguments_bytes
    equal to :func:`spec_argument_bytes`."""
    deadline = time.monotonic() + DRYRUN_WAIT_S
    out = {}
    try:
        for arch, shape, log, p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            log.close()
            text = (pathlib.Path(out_dir) / f"{arch}_{shape}.log").read_text()
            check(p.returncode == 0, f"dryrun {arch} {shape} exited "
                                     f"{p.returncode}:\n{text[-3000:]}")
            rec = json.loads((pathlib.Path(out_dir)
                              / f"{arch}_{shape}_single.json").read_text())
            want = spec_argument_bytes(get_arch(arch), shape)
            got = rec["memory_per_device"]["arguments_bytes"]
            check(rec["status"] == "ok" and got == want,
                  f"dryrun {arch} {shape}: status {rec['status']}, "
                  f"arguments_bytes {got} != {want} from the specs")
            mem = rec["memory_per_device"]
            print(f"[mesh] dryrun {arch} {shape} on the fake 16 x 16 mesh "
                  f"(256 ranks, the host's CPU): ok in {rec['compile_s']} s; "
                  f"arguments_bytes {got} a device, from the specs {want}; "
                  f"peak {mem['peak_bytes']}, fits 80 GiB "
                  f"{mem['fits_80GiB_hbm']}; flops "
                  f"{rec['cost_analysis_raw']['flops']:.4g}; collectives "
                  f"{rec['collectives_prod_bytes']}; roofline dominant "
                  f"{rec.get('roofline', {}).get('dominant')} ({smi})")
            out[f"{arch} {shape}"] = {
                "compile_s": rec["compile_s"], "arguments_bytes": got,
                "spec_arguments_bytes": want, "memory_per_device": mem,
                "flops": rec["cost_analysis_raw"]["flops"],
                "collectives_prod_bytes": rec["collectives_prod_bytes"],
                "roofline": rec.get("roofline")}
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


def phase_mesh(smi: str, train_losses: list, serve_tokens: list,
               dryruns: list, dryrun_dir: str) -> dict:
    """The model on a mesh: ``launch.mesh.make_host_mesh()`` on one NCCL
    rank is a (1, 1) ('data', 'model') mesh.  gemma-2b at full width and
    depth trains MESH_TRAIN_STEPS steps through ``build_train_step(cfg,
    mesh, ...)`` (parameters, moments and batches laid out by the rules,
    DTensors of one shard), each loss against the first losses of
    ``train_gemma2b``'s run without a mesh (the same seed, batches and
    schedule); gemma3-12b's ``generate(..., rules=)`` at full width
    against ``serve_gemma3_12b``'s tokens; then the dry runs'
    records."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import shard_batch, shard_params
    from repro_torch.sharding import make_rules
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if DEVICE == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",
            init_method=f"file://{tmp}/pg", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=MULTIPROC_GROUP_TIMEOUT_S))
        try:
            mesh = make_host_mesh()
            check(tuple(mesh.shape) == (1, 1) and mesh.device_type == DEVICE
                  and mesh.mesh_dim_names == ("data", "model"),
                  f"make_host_mesh() on one NCCL rank: {mesh}")
            cfg = get_arch(TRAIN_ARCH)
            shape = ShapeSpec("mesh_train_gemma2b", "train", TRAIN_SEQ,
                              TRAIN_B)
            adamw_cfg = AdamWConfig(lr=TRAIN_LR)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = lm_params(cfg, "mesh_train_gemma2b")[0]
            bundle = build_train_step(
                cfg, mesh, shape, remat="full", adamw=adamw_cfg,
                lr_schedule=lambda s: cosine_schedule(
                    s, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
            params = shard_params(bundle.rules, params)
            opt = adamw_init(params, adamw_cfg)
            pipe = TokenPipeline(cfg.vocab_size, TRAIN_B, TRAIN_SEQ,
                                 seed=SEED)
            losses, step_ms = [], []
            for step in range(MESH_TRAIN_STEPS):
                data = shard_batch(bundle.rules,
                                   batch_on(pipe.batch_at(step), DEVICE))
                torch.cuda.synchronize()
                t0 = time.monotonic()
                params, opt, metrics = on_path(
                    "mesh_train_gemma2b", lambda: bundle.fn(params, opt,
                                                            data))
                step_ms.append((time.monotonic() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
            peak = torch.cuda.max_memory_allocated()
            want = train_losses[:MESH_TRAIN_STEPS]
            diff = max(abs(a - b) for a, b in zip(losses, want))
            check(diff <= 1e-5 * max(abs(b) for b in want),
                  f"mesh train: losses {losses} against {want} without a "
                  f"mesh")
            flash = PATH_LAUNCHES["mesh_train_gemma2b"]["flash_attention"]
            check(flash == 2 * attention_layers(cfg) * MESH_TRAIN_STEPS,
                  f"mesh train: {flash} flash launches in "
                  f"{MESH_TRAIN_STEPS} steps")
            median = float(np.median(step_ms[1:]))
            print(f"[mesh] {cfg.name} trains {MESH_TRAIN_STEPS} steps on "
                  f"make_host_mesh() = (1, 1) over one NCCL rank: losses "
                  f"{losses}, without a mesh {want} (bitwise "
                  f"{losses == want}, largest difference {diff}); a step "
                  f"{median:.1f} ms (median of steps 2-{MESH_TRAIN_STEPS}; "
                  f"the first {step_ms[0]:.1f}), peak memory "
                  f"{peak / 1e9:.2f} GB; first measured without a mesh: "
                  f"{NO_MESH_STEP_MS} ms, {NO_MESH_PEAK_GB} GB ({smi})")
            out["train_gemma2b"] = {
                "losses": losses, "losses_without_mesh": want,
                "bitwise": losses == want, "largest_difference": diff,
                "step_ms": step_ms, "step_median_ms": median,
                "max_memory_allocated_bytes": peak}
            del params, opt, bundle, metrics, data
            torch.cuda.empty_cache()

            cfg = get_arch(SERVE_ARCH)
            params = lm_params(cfg, "mesh_serve_gemma3_12b")[0]
            rules = make_rules(mesh, cfg)
            prompts = np.random.default_rng(SEED).integers(
                0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
            tokens, seconds, peak = served(
                "mesh_serve_gemma3_12b", shard_params(rules, params), cfg,
                prompts, SERVE_NEW, rules=rules)
            check(tokens.tolist() == serve_tokens,
                  "mesh serve: gemma3-12b's tokens on the (1, 1) mesh differ "
                  "from serve_gemma3_12b's without a mesh")
            print(f"[mesh] {cfg.name} generate {SERVE_B} x {SERVE_PROMPT} + "
                  f"{SERVE_NEW} with rules of the (1, 1) mesh: the tokens "
                  f"of the run without a mesh; {seconds:.2f} s first call, "
                  f"peak memory {peak / 2**30:.2f} GiB ({smi})")
            out["serve_gemma3_12b"] = {"generate_first_call_s": seconds,
                                       "max_memory_allocated_bytes": peak}
            del params
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    out["dryrun"] = collect_dryruns(dryruns, dryrun_dir, smi)
    return out


def phase_bucketing(smi: str) -> dict:
    """``data.smms_length_bucketing`` of BUCKETS x BUCKET_DOCS document
    lengths (numpy, 1 to 8192 tokens, from SEED) on the card against the
    CPU: the order, the bucket ids and every report field equal; the
    documents a bucket and the padding share if each bucket is padded
    to its longest document; the median of 5 calls."""
    lengths = np.random.default_rng(SEED).integers(1, 8193,
                                                   BUCKETS * BUCKET_DOCS)
    PATH_KERNELS["bucketing"] = {
        "bitonic_sort_kv" if cost_model_family(BUCKET_DOCS) == "bitonic"
        else "radix_sort", "searchsorted", "merge_rows_kv"}
    order, bucket, rep = on_path("bucketing", lambda: smms_length_bucketing(
        lengths, BUCKETS, device=DEVICE))
    order_cpu, bucket_cpu, rep_cpu = smms_length_bucketing(
        lengths, BUCKETS, device="cpu")
    check(np.array_equal(order, order_cpu), "bucketing: card order != CPU")
    check(np.array_equal(bucket, bucket_cpu),
          "bucketing: card bucket ids != CPU")
    _same_report("bucketing", rep, rep_cpu)
    check(np.all(np.diff(lengths[order]) >= 0),
          "bucketing: the order does not sort the lengths")
    docs = np.bincount(bucket, minlength=BUCKETS)
    longest = np.maximum.reduceat(lengths[order], np.r_[0, np.cumsum(
        docs)[:-1]])
    waste = 1 - lengths.sum() / float((longest * docs).sum())
    timing = e2e("bucketing", lambda: smms_length_bucketing(
        lengths, BUCKETS, device=DEVICE), smi)
    print(f"[bucketing] {BUCKETS} buckets of {BUCKET_DOCS} documents on the "
          f"card: order, bucket ids and report equal to the CPU run; "
          f"k_workload {rep.k_workload:.4f}, alpha {rep.alpha}; documents "
          f"a bucket {int(docs.min())}-{int(docs.max())}; padded to each "
          f"bucket's longest, {waste:.4f} of the tokens are padding")
    return {"k_workload": rep.k_workload, "k_network": rep.k_network,
            "alpha": rep.alpha, "bucket_docs": [int(x) for x in docs],
            "padding_share": waste, **timing}


# ---------------------------------------------------------------------------
# 8. times
# ---------------------------------------------------------------------------

def phase_times(rng, smi: str) -> dict:
    dev = torch.device(DEVICE)
    res = {}

    def record(name, kernel, plain_ms, library_ms, nbytes, nops,
               ops_per_s=FP32_OPS_PER_S):
        ms, host_ms = kernel
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / ops_per_s * 1e3
        res[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "bytes": nbytes, "ops": nops}
        library = ("none" if library_ms is None
                   else f"{library_ms:.4f} ms")
        print(f"[times] {name:15s} kernel {ms:.4f} ms (host issues a call "
              f"in {host_ms:.4f} ms) | plain {plain_ms:.4f} "
              f"ms | library {library} | bound "
              f"{max(bytes_ms, ops_ms):.5f} ms "
              f"({res[name]['bound_by']}) ({smi})")

    # bitonic_sort at (64, 65536) f32: in + out once each; a comparison
    # sort needs log2 m compares per key, not the network's log2(m)^2 / 2
    x = torch.from_numpy(uniform_keys(T * M, seed=SEED).reshape(T, M)).to(dev)
    record("bitonic_sort",
           timed_ms(lambda: bitonic.bitonic_sort(x), 20),
           event_ms(lambda: bitonic.bitonic_sort_plain(x), 3, warm=1),
           event_ms(lambda: torch.sort(x, dim=-1), 20),
           2 * x.numel() * 4, x.numel() * int(math.log2(M)))
    # the same sort on the rows of its other representations, which no
    # path hands it: a +0.0 every 97th key (keys that fold: float32 sorts
    # as 64-bit words, bf16 compares its words' key half) and a NaN every
    # 997th (the keys as they are, the exact comparator)
    for dtype in (torch.float32, torch.bfloat16):
        for label, col, fill in (("folds", 97, 0.0), ("nan", 997, math.nan)):
            rows = x.to(dtype, copy=True)
            rows[:, ::col] = fill
            name = f"bitonic_sort@{label}" + (
                "_bf16" if dtype == torch.bfloat16 else "")
            record(name,
                   timed_ms(lambda: bitonic.bitonic_sort(rows), 20),
                   event_ms(lambda: bitonic.bitonic_sort_plain(rows), 1,
                            warm=1),
                   event_ms(lambda: torch.sort(rows, dim=-1), 20),
                   2 * rows.numel() * rows.element_size(),
                   rows.numel() * int(math.log2(M)))
            del rows

    # bitonic_sort_kv at (64, 65536): f32 keys and the int32 iota in,
    # keys and the order out; a comparison sort needs log2 m compares a
    # key.  The yardstick is one stable torch.sort, values and indices.
    iota = torch.arange(M, dtype=torch.int32, device=dev).repeat(T, 1)
    record("bitonic_sort_kv",
           timed_ms(lambda: bitonic.bitonic_sort_kv(x, iota), 20),
           event_ms(lambda: bitonic.bitonic_sort_kv_plain(x, iota), 3,
                    warm=1),
           event_ms(lambda: torch.sort(x, dim=-1, stable=True), 20),
           4 * x.numel() * 4, x.numel() * int(math.log2(M)))

    # the call ops.sort_kv makes (the paths' pair sort: SMMS Round 1 with
    # the payload, the local joins): no values, the kernel generates the
    # iota.  Keys in; keys and the order out.
    record("bitonic_sort_kv@ops",
           timed_ms(lambda: bitonic.bitonic_sort_kv(x), 20),
           event_ms(lambda: bitonic.bitonic_sort_kv_plain(x), 3, warm=1),
           event_ms(lambda: torch.sort(x, dim=-1, stable=True), 20),
           3 * x.numel() * 4, x.numel() * int(math.log2(M)))

    # searchsorted: 63 queries into each of 64 sorted rows; a binary
    # search must read only its probes, not the rows
    xs = bitonic.bitonic_sort(x)
    q = xs[:, ::M // T][:, 1:].contiguous()
    steps = math.ceil(math.log2(M + 1))
    probes = T * (T - 1) * steps
    record("searchsorted",
           timed_ms(lambda: bucketize.searchsorted(xs, q), 200),
           event_ms(lambda: bucketize.searchsorted_plain(xs, q), 10),
           event_ms(lambda: torch.searchsorted(xs, q, out_int32=True), 200),
           q.numel() * 4 * 2 + probes * 4, probes)
    # the path's own call (core/exchange.py:partition_sorted, SMMS's Round
    # 3 cut): the sorted (64, 65536) rows, the 63 interior boundaries as
    # one (63,) row, valid_len = m.  The yardstick: torch.searchsorted of
    # the same row expanded to every key row (made once, outside the
    # timing); the clamp to valid_len = 65536 changes nothing there.
    row = xs[0, ::M // T][1:].contiguous()
    rows_q = row.expand(T, -1).contiguous()
    record("searchsorted@ops",
           timed_ms(lambda: ops.searchsorted(xs, row, valid_len=M), 200),
           event_ms(lambda: torch.clamp_max(bucketize.searchsorted_plain(
               xs, rows_q), M), 10),
           event_ms(lambda: torch.searchsorted(xs, rows_q, out_int32=True),
                    200),
           row.numel() * 4 + q.numel() * 4 + probes * 4, probes)

    # sort_partition at Terasort's Round 3: (64, 65536) f32 and the 63
    # boundaries every machine shares.  Keys in; sorted keys and cuts
    # out; log2 m compares a key to sort and ceil(log2(m+1)) a query to
    # search.  The yardstick: torch.sort, then torch.searchsorted.
    bq = xs[:1, ::M // T][:, 1:].expand(T, T - 1).contiguous()
    search_ops = bq.numel() * steps
    record("sort_partition",
           timed_ms(lambda: fused.sort_partition(x, bq), 20),
           event_ms(lambda: fused.sort_partition_plain(x, bq), 3, warm=1),
           event_ms(lambda: torch.searchsorted(
               torch.sort(x, dim=-1).values, bq, out_int32=True), 20),
           2 * x.numel() * 4 + bq.numel() * 8,
           x.numel() * int(math.log2(M)) + search_ops)

    # sort_partition_kv at the same shape (Terasort Round 3 with the
    # payload): keys in; keys, the int32 order and the cuts out.  The
    # yardstick: a stable torch.sort, values and indices, then
    # torch.searchsorted.
    def sort_then_search():
        ks = torch.sort(x, dim=-1, stable=True)
        return ks.indices, torch.searchsorted(ks.values, bq, out_int32=True)

    record("sort_partition_kv",
           timed_ms(lambda: fused.sort_partition_kv(x, bq), 20),
           event_ms(lambda: fused.sort_partition_kv_plain(x, bq), 3, warm=1),
           event_ms(sort_then_search, 20),
           3 * x.numel() * 4 + bq.numel() * 8,
           x.numel() * int(math.log2(M)) + search_ops)

    # the call ops.sort_partition_kv makes (Terasort's Round 3 with the
    # records, core/exchange.py): the (63,) boundary row made into one
    # query row a key row, then the fused pair sort
    brow = bq[0].contiguous()
    record("sort_partition_kv@ops",
           timed_ms(lambda: fused.sort_partition_kv(
               x, ops._query_rows(x, brow)), 20),
           event_ms(lambda: fused.sort_partition_kv_plain(x, bq), 3, warm=1),
           event_ms(sort_then_search, 20),
           3 * x.numel() * 4 + bq.numel() * 8,
           x.numel() * int(math.log2(M)) + search_ops)

    # and at RandJoin's routing: (64, 2048) int32 draws, 7 boundaries
    a = torch.randint(0, 8, (T, 2048), dtype=torch.int32, device=dev)
    aq = torch.arange(1, 8, dtype=torch.int32, device=dev).expand(T, 7) \
        .contiguous()

    def routing_yardstick():
        ks = torch.sort(a, dim=-1, stable=True)
        return ks.indices, torch.searchsorted(ks.values, aq, out_int32=True)

    record("sort_partition_kv@routing",
           timed_ms(lambda: fused.sort_partition_kv(a, aq), 200),
           event_ms(lambda: fused.sort_partition_kv_plain(a, aq), 10),
           event_ms(routing_yardstick, 200),
           3 * a.numel() * 4 + aq.numel() * 8,
           a.numel() * 11 + aq.numel() * 12)

    # radix_sort at (64, 65536) f32: keys in; sorted keys and the int32
    # order out (12 bytes a key); one digit count a key a pass.  The
    # yardstick: a stable torch.sort, values and indices.
    record("radix_sort",
           timed_ms(lambda: radix.radix_sort(x), 20),
           event_ms(lambda: radix.radix_sort_plain(x), 3, warm=1),
           event_ms(lambda: torch.sort(x, dim=-1, stable=True), 20),
           3 * x.numel() * 4,
           x.numel() * (32 // radix.DEFAULT_RADIX_BITS))
    # the same at the wide paths' (64, 262144), float32 (12 bytes a key)
    # and bf16 (8); the plain version once
    xw = torch.from_numpy(uniform_keys(T * M_WIDE, seed=SEED + 7)
                          .reshape(T, M_WIDE)).to(dev)
    for suffix, keys in (("wide", xw), ("wide_bf16", xw.to(torch.bfloat16))):
        record(f"radix_sort@{suffix}",
               timed_ms(lambda: radix.radix_sort(keys), 10),
               event_ms(lambda: radix.radix_sort_plain(keys), 1, warm=0),
               event_ms(lambda: torch.sort(keys, dim=-1, stable=True), 10),
               keys.numel() * (2 * keys.element_size() + 4),
               keys.numel() * (8 * keys.element_size()
                               // radix.DEFAULT_RADIX_BITS))
    radix_keys = {"f32": x, "bf16": x.to(torch.bfloat16),
                  "int32": xw.view(torch.int32)[:, :M].contiguous()}
    del xw, keys

    # merge_rows at the small configuration's receive buffers
    cap = flat_receive_capacity(M_SMALL, T_SMALL, cluster.CapacityPolicy.smms(
        T_SMALL * M_SMALL, T_SMALL, 2).first_factor) // T_SMALL
    # (in + out once each; ceil(log2 t) compares per key merge t rows)
    r = torch.sort(torch.rand((T_SMALL, T_SMALL, cap), device=dev),
                   dim=-1).values
    record("merge_rows",
           timed_ms(lambda: bitonic.merge_sorted_rows(r), 200),
           event_ms(lambda: bitonic.merge_sorted_rows_plain(r), 10),
           event_ms(lambda: torch.sort(r.reshape(T_SMALL, -1), dim=-1), 200),
           2 * r.numel() * 4, r.numel() * math.ceil(math.log2(T_SMALL)))

    # merge_rows_kv (the argsort merge) at the same receive buffers:
    # keys in; keys and the int32 order out
    record("merge_rows_kv",
           timed_ms(lambda: bitonic.merge_sorted_rows_argsort(r), 200),
           event_ms(lambda: bitonic.merge_sorted_rows_argsort_plain(r), 10),
           event_ms(lambda: torch.sort(r.reshape(T_SMALL, -1), dim=-1,
                                       stable=True), 200),
           3 * r.numel() * 4, r.numel() * math.ceil(math.log2(T_SMALL)))

    # merge_ranks at PR 16's shape, the main path's rows padded to (64,
    # 64, 4096) with their pad ids, bound block 2048 (ignored on the
    # card): keys and ids in, positions out; merging t sorted rows needs
    # at most ceil(log2 t) compares per key.  Then the rank merge as the
    # paths call it, at their own landed rows.
    kp, ip, recv = _main_rank_operands(rng, dev)
    bb = ops.RANK_MERGE_BOUND_BLOCK
    flat = recv.reshape(T, -1)
    record("merge_ranks",
           timed_ms(lambda: fused.merge_ranks(kp, ip, bb), 10),
           event_ms(lambda: fused.merge_ranks_plain(kp, ip, bb), 1, warm=0),
           event_ms(lambda: torch.sort(flat, dim=-1), 20),
           (kp.numel() + ip.numel() + kp.numel()) * 4,
           kp.numel() * math.ceil(math.log2(kp.shape[-2])))
    rank_merge_times(record, {"4096": kp, **RANK_OPERANDS})
    replay_times(record, dev)

    # bucketize_histogram at SMMS's shape: 4,194,304 f32 keys into 64
    # buckets.  Keys and boundaries in, int32 ids and counts out; a
    # binary search of ceil(log2 t) compares a key.  The yardstick:
    # torch.bucketize (right side), then torch.bincount.
    hist_keys = x.reshape(-1)
    hist_bounds = torch.sort(hist_keys).values[M::M].contiguous()
    record("bucketize_histogram",
           timed_ms(lambda: bucketize.bucketize_histogram(
               hist_keys, hist_bounds, T), 50),
           event_ms(lambda: bucketize.bucketize_histogram_plain(
               hist_keys, hist_bounds, T), 5),
           event_ms(lambda: torch.bincount(torch.bucketize(
               hist_keys, hist_bounds, right=True), minlength=T), 50),
           2 * hist_keys.numel() * 4 + (hist_bounds.numel() + T) * 4,
           hist_keys.numel() * math.ceil(math.log2(T)))
    hist_keys_bf16 = hist_keys.to(torch.bfloat16)
    hist_bounds_bf16 = torch.sort(hist_keys_bf16).values[M::M].contiguous()

    # flash_attention at gemma3-12b's prefill: B = 4, 16 q / 8 kv heads,
    # S = 2048, d = 256, bf16 (the tensor-core kernel), causal.  q, k, v
    # in, out once; the causal half of 4 * B * Hq * S^2 * d flops at the
    # bf16 tensor-core peak.  The yardstick: scaled_dot_product_attention
    # with is_causal and enable_gqa.  Also with the 1024-token window
    # (work: the band each query sees).
    cfg = get_arch(SERVE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, hq, hkv, s, d = (SERVE_B, cfg.n_heads, cfg.n_kv_heads, SERVE_PROMPT,
                        cfg.head_dim_)
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    qkv_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, window in (("flash_attention", None),
                          ("flash_attention@window", cfg.sliding_window)):
        seen = sum(min(i + 1, window or s) for i in range(s))  # keys a row sees
        mask = None
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
        record(label,
               timed_ms(lambda: fa.flash_attention(q, k, v, True, window), 5),
               event_ms(lambda: fa.flash_attention_plain(q, k, v, True,
                                                         window), 1, warm=1),
               event_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                     is_causal=window is None,
                                     enable_gqa=True), 20),
               qkv_bytes, 4 * b * hq * seen * d, BF16_OPS_PER_S)
    # the same call in float32: the CUDA-core kernel (the smoke
    # configuration's 1e-5 path), against the CUDA cores' f32 peak
    qf, kf, vf = q.float(), k.float(), v.float()
    seen = s * (s + 1) // 2
    record("flash_attention@f32",
           timed_ms(lambda: fa.flash_attention(qf, kf, vf, True, None), 3),
           event_ms(lambda: fa.flash_attention_plain(qf, kf, vf, True, None),
                    1, warm=1),
           event_ms(lambda: sdpa(qf, kf, vf, is_causal=True,
                                 enable_gqa=True), 5),
           2 * qkv_bytes, 4 * b * hq * seen * d)
    del q, k, v, qf, kf, vf
    # musicgen-medium's prefill: MHA, 24 heads of 64, bf16, causal
    mg = get_arch("musicgen-medium")
    q, k, v = (torch.randn((b, mg.n_heads, s, mg.head_dim_), generator=gen,
                           device=dev).bfloat16() for _ in range(3))
    record("flash_attention@musicgen",
           timed_ms(lambda: fa.flash_attention(q, k, v, True, None), 5),
           event_ms(lambda: fa.flash_attention_plain(q, k, v, True, None),
                    1, warm=1),
           event_ms(lambda: sdpa(q, k, v, is_causal=True), 20),
           4 * q.numel() * 2, 4 * b * mg.n_heads * seen * mg.head_dim_,
           BF16_OPS_PER_S)
    del q, k, v
    # pixtral-12b's prefill (B = 4, 32 q / 8 kv heads of 128, S = 2304:
    # 256 front-end positions and 2048 tokens), the jamba cut's
    # attention layer (B = 1, 64 q / 8 kv heads of 128, S = 1024) and
    # gemma-2b's training step (B = 4, 8 q / 1 kv head of 256, S =
    # 2048), bf16, causal
    px, jb = get_arch(VLM_ARCH), get_arch(HYBRID_ARCH)
    for label, (bb, arch, ss) in (
            ("flash_attention@pixtral",
             (SERVE_B, px, px.n_frontend_tokens + SERVE_PROMPT)),
            ("flash_attention@jamba", (HYBRID_B, jb, HYBRID_PROMPT)),
            ("flash_attention@gemma2b",
             (TRAIN_B, get_arch(TRAIN_ARCH), TRAIN_SEQ))):
        hd = arch.head_dim_
        q = torch.randn((bb, arch.n_heads, ss, hd), generator=gen,
                        device=dev).bfloat16()
        k, v = (torch.randn((bb, arch.n_kv_heads, ss, hd), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        record(label,
               timed_ms(lambda: fa.flash_attention(q, k, v, True, None), 5),
               event_ms(lambda: fa.flash_attention_plain(q, k, v, True,
                                                         None), 1, warm=1),
               event_ms(lambda: sdpa(q, k, v, is_causal=True,
                                     enable_gqa=True), 20),
               (2 * q.numel() + k.numel() + v.numel()) * 2,
               4 * bb * arch.n_heads * (ss * (ss + 1) // 2) * hd,
               BF16_OPS_PER_S)
        del q, k, v
    bf16_times(record, rng, x, xs)
    rb = r.to(torch.bfloat16)
    xb, bqb = x.to(torch.bfloat16), bq.to(torch.bfloat16)

    def sort_bitonic(keys):              # the call ops.sort makes
        with ops.force_sort_kernel("bitonic"):
            return ops.sort(keys)

    device = one_launch(smi, {
        "bitonic_sort@ops": lambda: sort_bitonic(x),
        "bitonic_sort@ops_bf16": lambda: sort_bitonic(xb),
        "sort_partition": lambda: fused.sort_partition(x, bq),
        "sort_partition@bf16": lambda: fused.sort_partition(xb, bqb),
        "bitonic_sort_kv@ops": lambda: bitonic.bitonic_sort_kv(x),
        "bitonic_sort_kv@routing": lambda: bitonic.bitonic_sort_kv(a),
        "sort_partition_kv": lambda: fused.sort_partition_kv(x, bq),
        "sort_partition_kv@routing": lambda: fused.sort_partition_kv(a, aq),
        "merge_rows_kv": lambda: bitonic.merge_sorted_rows_argsort(r),
        "merge_rows_kv@bf16": lambda: bitonic.merge_sorted_rows_argsort(rb),
        "merge_rows": lambda: bitonic.merge_sorted_rows(r),
        "searchsorted@ops": lambda: ops.searchsorted(xs, row, valid_len=M),
        "bucketize_histogram": lambda: bucketize.bucketize_histogram(
            hist_keys, hist_bounds, T),
        "bucketize_histogram@bf16": lambda: bucketize.bucketize_histogram(
            hist_keys_bf16, hist_bounds_bf16, T)})
    # the card's own time a call beside the back-to-back time, which the
    # host's issue time bounds for the histogram
    for label, ms in device.items():
        if label in res:
            res[label]["device_ms"] = ms
    radix_launches(smi, radix_keys)
    # out of the end-to-end peaks below
    del xb, bqb, radix_keys, hist_keys_bf16, hist_bounds_bf16

    # the end-to-end sorts by both families, in turns: SMMS and
    # Terasort (its draws made on the card from the seed, as a user's
    # call makes them), keys only and with the 100-byte records (the
    # payload lives on the card, the keys come from the host)
    xn = uniform_keys(T * M, seed=SEED).reshape(T, M)
    for algorithm in PATHS:
        for with_payload in (False, True):
            payload = (make_payload(T, M, SEED, device=DEVICE)
                       if with_payload else None)
            label = (f"cluster.sort {algorithm} t={T} m={M} uniform"
                     + (f", {PAYLOAD_COLS} x int32 payload"
                        if with_payload else ""))
            times = e2e_families(label, lambda: cluster.sort(
                xn, algorithm=algorithm, seed=SEED, values=payload,
                device=DEVICE), smi)
            for family, entry in times.items():
                res[path_name(algorithm, with_payload, family) + "_e2e"] = \
                    entry
            del payload

    # RandJoin on both tables, the default capacity's host statistics
    # included
    for name in ("randjoin_zipf", "randjoin_scalar_skew"):
        cfg = JOINS[name]
        s, t = cfg.tables()
        rows_s = np.arange(len(s), dtype=np.int32)
        rows_t = np.arange(len(t), dtype=np.int32)
        res[f"{name}_e2e"] = e2e(
            f"cluster.join {name} t={JOIN_T}",
            lambda: cluster.join(s, rows_s, t, rows_t, algorithm="randjoin",
                                 t_machines=JOIN_T, seed=SEED, device=DEVICE,
                                 **cfg.options), smi)

    # StatJoin on the Zipf tables, host planning and routing included
    s, t = JOINS["statjoin_zipf"].tables()
    rows_s = np.arange(len(s), dtype=np.int32)
    rows_t = np.arange(len(t), dtype=np.int32)
    res["statjoin_zipf_e2e"] = e2e(
        f"cluster.join statjoin t={JOIN_T} Zipf 2^17 x 2^17",
        lambda: cluster.join(s, rows_s, t, rows_t, algorithm="statjoin",
                             t_machines=JOIN_T, device=DEVICE), smi)

    # the host side of StatJoin alone, on the scalar-skew tables
    s, t = JOINS["statjoin_scalar_skew"].tables()
    t0 = time.perf_counter()
    stats = statjoin_mod.collect_statistics(s, t)
    t1 = time.perf_counter()
    plan = statjoin_mod.plan_statjoin(stats, JOIN_T)
    t2 = time.perf_counter()
    for keys, side in ((s, "s"), (t, "t")):
        statjoin_mod._routing_tensors(keys, plan, JOIN_T, side)
    t3 = time.perf_counter()
    res["statjoin_scalar_skew_host"] = {
        "rectangles": len(plan), "statistics_ms": (t1 - t0) * 1e3,
        "plan_ms": (t2 - t1) * 1e3, "routing_ms": (t3 - t2) * 1e3}
    print(f"[times] StatJoin host side, scalar skew 2^20, t={JOIN_T}: "
          f"{len(plan)} rectangles; statistics {(t1 - t0) * 1e3:.1f} ms, "
          f"plan {(t2 - t1) * 1e3:.1f} ms, routing (both sides) "
          f"{(t3 - t2) * 1e3:.1f} ms (host clock)")
    return res


# The spin kernels (torch.cuda._sleep, clock cycles) around a profiled
# window: ~25 ms before the calls, so that they run once the profiler
# records, and a short one after them.  With nothing around them a window
# of a few calls lost some or all of their kernels' events on the card.
SPIN_BEFORE, SPIN_AFTER = 50_000_000, 1000


def profiled_kernels(fn, calls: int = 10, durations: Optional[dict] = None
                     ) -> collections.Counter:
    """The device kernels (and memsets) ``calls`` calls of ``fn`` run
    under torch.profiler, by name, with ``cuda.LAUNCHES`` set to 0 just
    before them.  ``fn`` runs once before the window, so only the calls'
    own work is in it; the window's spin kernels
    (:data:`SPIN_BEFORE`) are left out.  ``durations``, where given,
    gets each name's device ms a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_BEFORE)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(SPIN_AFTER)
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in ev.name]
    if durations is not None:
        for ev in events:
            durations[ev.name] = (durations.get(ev.name, 0.0)
                                  + ev.device_time / 1e3 / calls)
    return collections.Counter(ev.name for ev in events)


def one_launch(smi: str, calls: dict) -> dict:
    """Each call is one C call and one kernel on the card: under
    torch.profiler, 10 calls run 10 device kernels, all of one name, and
    no copy or fill; and ``cuda.LAUNCHES`` counts 10.  Returns label ->
    the kernel's device ms a call (the profiler's), the card's own time
    where the host issues calls slower than the card runs them."""
    device = {}
    for label, fn in calls.items():
        durations = {}
        kernels = profiled_kernels(fn, durations=durations)
        device[label] = sum(durations.values())
        print(f"[times] {label}: 10 calls ran {dict(kernels)}, "
              f"{dict(cuda.LAUNCHES)} C calls, {device[label]:.5f} ms of "
              f"device time a call ({smi})")
        check(len(kernels) == 1 and sum(kernels.values()) == 10
              and sum(cuda.LAUNCHES.values()) == 10,
              f"{label}: a call is not one C call and one kernel "
              f"({dict(kernels)}, {dict(cuda.LAUNCHES)})")
    return device


def radix_launches(smi: str, keys: dict) -> None:
    """The radix sort's launches a call (``csrc/radix_sort.cu``): under
    torch.profiler, 10 calls at (64, 65536) run 10 memsets of the
    scratch, 10 upfront histograms and 10 onesweep passes per 8 key bits
    (40 for 32-bit keys, 20 for bf16) and nothing else; ``cuda.LAUNCHES``
    counts 10 C calls."""
    for dname, x in keys.items():
        passes = radix.key_bits(x.dtype) // radix.RADIX_KERNEL_BITS
        kinds = collections.Counter()
        for name, n in profiled_kernels(lambda: radix.radix_sort(x)).items():
            kinds["memset" if "emset" in name else
                  "histogram" if "upfront_histogram" in name else
                  "pass" if "onesweep_pass" in name else name] += n
        print(f"[times] radix_sort@{dname}: 10 calls ran {dict(kinds)}, "
              f"{dict(cuda.LAUNCHES)} C calls ({smi})")
        check(dict(kinds) == {"memset": 10, "histogram": 10,
                              "pass": 10 * passes}
              and dict(cuda.LAUNCHES) == {"radix_sort": 10},
              f"radix_sort {dname}: a call is not one C call, one memset, "
              f"one histogram and {passes} passes ({dict(kinds)}, "
              f"{dict(cuda.LAUNCHES)})")


def rank_merge_times(record, operands: dict) -> None:
    """The rank merge as the paths call it (``fused.rank_merge``: keys
    in, merged keys and the int32 order out), ``merge_ranks@<name>``, at
    (64, 64, 4096) rows of real keys and at the landed rows each sort
    path handed it (:data:`RANK_OPERANDS`), beside one stable torch.sort
    of the same keys, values and indices.  Bound: the keys read once,
    the merged keys and the order written once; merging t sorted rows
    needs ceil(log2 t) compares a key."""
    for name, keys in operands.items():
        keys = keys.to(DEVICE)
        batch, t, c = keys.shape
        n = keys.numel()
        flat = keys.reshape(batch, -1)
        record(f"merge_ranks@{name}",
               timed_ms(lambda: fused.rank_merge(keys), 10),
               event_ms(lambda: fused.rank_merge_plain(keys), 1, warm=0),
               event_ms(lambda: torch.sort(flat, dim=-1, stable=True), 10),
               n * (2 * keys.element_size() + 4),
               n * math.ceil(math.log2(t)))


def replay_times(record, dev) -> None:
    """The NaN replay alone (``merge_ranks_replay``, ROADMAP C15): one
    merge call leaves the entries' flags, merged keys and order, then
    the replay's C call is timed over them (it rewrites the flagged
    entries the same way each time): at C15's rows in f32, a clean entry
    beside, which it skips; and at SMMS's landed rows (64, 64, 2152)
    with one NaN entry (``@smms``: a (64, 4096) padded entry).  Plain:
    the plain replay of the flagged entries.  Bound: their keys read
    once, their merged keys and order written once; operations: one
    compare a probe, at the reference's fixed step count.  No library
    call computes it."""
    for name, keys in (("merge_ranks_replay",
                        c15_rows("C15 (4, 16500), blocked").to(dev)),
                       ("merge_ranks_replay@smms", smms_nan_rows(dev))):
        batch, t, c = keys.shape
        merged, order, flags = fused._launch_merge(keys, None, None)
        bb = fused._rank_merge_block(c)
        nan = fused._nan_entries(keys)
        dirty = keys[nan]
        tp2, cp2 = bitonic._next_pow2(t), max(2, bitonic._next_pow2(c))
        width = bb or cp2
        probes = (len(dirty) * tp2 * cp2 * tp2 * (cp2 // width)
                  * math.ceil(math.log2(width + 1)))
        record(name,
               timed_ms(lambda: fused._launch_replay(
                   keys, None, flags, merged, order, None, bb), 10),
               event_ms(lambda: fused._merge_replay(dirty), 1, warm=0),
               None, dirty.numel() * (2 * keys.element_size() + 4), probes)


def bf16_times(record, rng, x, xs) -> None:
    """Each sort-side kernel on bf16 keys, at the float32 entries' shapes
    (``<kernel>@bf16``): the same work with 2-byte keys, so the bytes
    bound counts 2 bytes a key; the yardsticks are the same torch calls
    on the bf16 operands."""
    dev = x.device
    xb = x.to(torch.bfloat16)
    n = xb.numel()
    lg = int(math.log2(M))
    iota = torch.arange(M, dtype=torch.int32, device=dev).repeat(T, 1)
    record("bitonic_sort@bf16",
           timed_ms(lambda: bitonic.bitonic_sort(xb), 20),
           event_ms(lambda: bitonic.bitonic_sort_plain(xb), 1, warm=1),
           event_ms(lambda: torch.sort(xb, dim=-1), 20), 2 * n * 2, n * lg)
    record("bitonic_sort_kv@bf16",
           timed_ms(lambda: bitonic.bitonic_sort_kv(xb, iota), 20),
           event_ms(lambda: bitonic.bitonic_sort_kv_plain(xb, iota), 1,
                    warm=1),
           event_ms(lambda: torch.sort(xb, dim=-1, stable=True), 20),
           n * (2 + 4) * 2, n * lg)
    # the call ops.sort_kv makes on bf16 keys: the order generated (the
    # kernel's 32-bit words); keys in, keys and the order out
    record("bitonic_sort_kv@ops_bf16",
           timed_ms(lambda: bitonic.bitonic_sort_kv(xb), 20),
           event_ms(lambda: bitonic.bitonic_sort_kv_plain(xb), 1, warm=1),
           event_ms(lambda: torch.sort(xb, dim=-1, stable=True), 20),
           n * (2 + 2 + 4), n * lg)
    record("radix_sort@bf16",
           timed_ms(lambda: radix.radix_sort(xb), 20),
           event_ms(lambda: radix.radix_sort_plain(xb), 1, warm=1),
           event_ms(lambda: torch.sort(xb, dim=-1, stable=True), 20),
           n * (2 + 2 + 4), n * (16 // radix.DEFAULT_RADIX_BITS))
    xsb = xs.to(torch.bfloat16)
    q = xsb[:, ::M // T][:, 1:].contiguous()
    steps = math.ceil(math.log2(M + 1))
    probes = T * (T - 1) * steps
    record("searchsorted@bf16",
           timed_ms(lambda: bucketize.searchsorted(xsb, q), 200),
           event_ms(lambda: bucketize.searchsorted_plain(xsb, q), 5),
           event_ms(lambda: torch.searchsorted(xsb, q, out_int32=True), 200),
           q.numel() * (2 + 4) + probes * 2, probes)
    bq = xsb[:1, ::M // T][:, 1:].expand(T, T - 1).contiguous()
    record("sort_partition@bf16",
           timed_ms(lambda: fused.sort_partition(xb, bq), 20),
           event_ms(lambda: fused.sort_partition_plain(xb, bq), 1, warm=1),
           event_ms(lambda: torch.searchsorted(
               torch.sort(xb, dim=-1).values, bq, out_int32=True), 20),
           2 * n * 2 + bq.numel() * 6, n * lg + bq.numel() * steps)
    record("sort_partition_kv@bf16",
           timed_ms(lambda: fused.sort_partition_kv(xb, bq), 20),
           event_ms(lambda: fused.sort_partition_kv_plain(xb, bq), 1,
                    warm=1),
           event_ms(lambda: torch.searchsorted(torch.sort(
               xb, dim=-1, stable=True).values, bq, out_int32=True), 20),
           n * (2 + 2 + 4) + bq.numel() * 6, n * lg + bq.numel() * steps)
    cap = flat_receive_capacity(M_SMALL, T_SMALL, cluster.CapacityPolicy.smms(
        T_SMALL * M_SMALL, T_SMALL, 2).first_factor) // T_SMALL
    r = torch.sort(torch.rand((T_SMALL, T_SMALL, cap), device=dev)
                   .to(torch.bfloat16), dim=-1).values
    lt = math.ceil(math.log2(T_SMALL))
    record("merge_rows@bf16",
           timed_ms(lambda: bitonic.merge_sorted_rows(r), 200),
           event_ms(lambda: bitonic.merge_sorted_rows_plain(r), 5),
           event_ms(lambda: torch.sort(r.reshape(T_SMALL, -1), dim=-1), 200),
           2 * r.numel() * 2, r.numel() * lt)
    record("merge_rows_kv@bf16",
           timed_ms(lambda: bitonic.merge_sorted_rows_argsort(r), 200),
           event_ms(lambda: bitonic.merge_sorted_rows_argsort_plain(r), 5),
           event_ms(lambda: torch.sort(r.reshape(T_SMALL, -1), dim=-1,
                                       stable=True), 200),
           r.numel() * (2 + 2 + 4), r.numel() * lt)
    kp, ip, recv = _main_rank_operands(rng, dev)
    kb, bb = kp.to(torch.bfloat16), ops.RANK_MERGE_BOUND_BLOCK
    record("merge_ranks@bf16",
           timed_ms(lambda: fused.merge_ranks(kb, ip, bb), 10),
           event_ms(lambda: fused.merge_ranks_plain(kb, ip, bb), 1, warm=0),
           event_ms(lambda: torch.sort(kb.reshape(T, -1), dim=-1), 20),
           kb.numel() * (2 + 4 + 4), kb.numel() * math.ceil(
               math.log2(kb.shape[-2])))
    rank_merge_times(record, {
        "smms_uniform_bf16": RANK_OPERANDS["smms_uniform"].to(torch.bfloat16)})
    bk = xb.reshape(-1)
    hb = torch.sort(bk).values[M::M].contiguous()
    record("bucketize_histogram@bf16",
           timed_ms(lambda: bucketize.bucketize_histogram(bk, hb, T), 50),
           event_ms(lambda: bucketize.bucketize_histogram_plain(bk, hb, T),
                    5),
           event_ms(lambda: torch.bincount(torch.bucketize(
               bk, hb, right=True), minlength=T), 50),
           bk.numel() * (2 + 4) + (hb.numel() * 2 + T * 4),
           bk.numel() * math.ceil(math.log2(T)))


def e2e_families(label: str, fn, smi: str, reps: int = 6) -> dict:
    """Median host-clock time of ``fn`` ending in a synchronize, by each
    sort family, the two in turns (bitonic, radix, radix, bitonic, ...);
    each family forced only where the cost model would pick the other.
    Returns family -> {"ms", "median_ms", "max_memory_allocated_bytes"}."""
    walls = {f: [] for f in FAMILIES}
    peaks = {f: 0 for f in FAMILIES}
    for i in range(reps):
        for family in (FAMILIES if i % 2 == 0 else FAMILIES[::-1]):
            with ops.force_sort_kernel(forced_family(family, M)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[family].append((time.perf_counter() - t0) * 1e3)
                peaks[family] = max(peaks[family],
                                    torch.cuda.max_memory_allocated())
    out = {}
    for family in FAMILIES:
        med = float(np.median(walls[family]))
        out[family] = {"ms": walls[family], "median_ms": med,
                       "max_memory_allocated_bytes": peaks[family]}
        print(f"[times] {label}, {family}: median {med:.2f} ms of {reps} "
              f"(host clock + synchronize), peak memory "
              f"{peaks[family] / 2**20:.1f} MiB ({smi})")
    return out


def phase_crossover(smi: str) -> dict:
    """The sort-family split measured on the card: ``ops.sort`` (keys
    only) and ``ops.sort_kv`` (a (64, n) int32 value gathered through
    the order) by each family at (64, 2^k), k = 10..16, float32, bf16
    and int32, CUDA-event ms and the host's issue ms; a stable
    torch.sort beside them as the yardstick.  Prints where radix was
    faster on the keys-only comparison, what the cost model picks there,
    what a radix pass cost in bitonic substages at each width, and the
    values of ``ops.RADIX_PASS_SUBSTAGES`` with which the model picks the
    faster family at every width from ``ops.RADIX_MIN_LANES`` on."""
    dev = torch.device(DEVICE)
    table = {}
    fit_lo, fit_hi = 0.0, math.inf
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        dname = str(dtype)[6:]
        passes = -(-radix.key_bits(dtype) // ops.RADIX_BITS)
        for k in range(10, 17):
            n = 1 << k
            reps = 50 if k < 14 else 20
            x = (torch.randint(-2**31, 2**31 - 1, (T, n), device=dev,
                               dtype=torch.int32) if dtype == torch.int32
                 else torch.rand((T, n), device=dev).to(dtype))
            v = torch.randint(0, 1 << 30, (T, n), dtype=torch.int32,
                              device=dev)
            row = {}
            for family in FAMILIES:
                with ops.force_sort_kernel(family):
                    row[f"{family}_sort"] = timed_ms(lambda: ops.sort(x), reps)
                    row[f"{family}_sort_kv"] = timed_ms(
                        lambda: ops.sort_kv(x, v), reps)
            row["library_stable_sort_ms"] = event_ms(
                lambda: torch.sort(x, dim=-1, stable=True), reps)
            row["radix_faster_keys"] = (row["radix_sort"][0]
                                        < row["bitonic_sort"][0])
            row["radix_faster_kv"] = (row["radix_sort_kv"][0]
                                      < row["bitonic_sort_kv"][0])
            row["cost_model"] = ops.sort_kernel_choice(x)
            # a radix pass in bitonic substages, and the model's bracket
            substages = k * (k + 1) // 2
            row["pass_substages"] = ((row["radix_sort"][0] / passes)
                                     / (row["bitonic_sort"][0] / substages))
            if n >= ops.RADIX_MIN_LANES:
                if row["radix_faster_keys"]:
                    fit_hi = min(fit_hi, substages / passes)
                else:
                    fit_lo = max(fit_lo, substages / passes)
            table[f"{dname}_2^{k}"] = row
            print(f"[times] crossover {dname} ({T}, 2^{k}): sort bitonic "
                  f"{row['bitonic_sort'][0]:.4f} radix "
                  f"{row['radix_sort'][0]:.4f} ms | sort_kv bitonic "
                  f"{row['bitonic_sort_kv'][0]:.4f} radix "
                  f"{row['radix_sort_kv'][0]:.4f} ms | host issue "
                  f"{row['bitonic_sort'][1]:.4f} / "
                  f"{row['radix_sort'][1]:.4f} ms | stable torch.sort "
                  f"{row['library_stable_sort_ms']:.4f} ms | a radix pass "
                  f"= {row['pass_substages']:.1f} bitonic substages | cost "
                  f"model: {row['cost_model']} ({smi})")
    faster = [key for key, row in table.items() if row["radix_faster_keys"]]
    agree = all((row["cost_model"] == "radix") == row["radix_faster_keys"]
                for row in table.values())
    print(f"[times] crossover: radix faster (keys only) at "
          f"{faster if faster else 'no width'}; "
          f"RADIX_MIN_LANES={ops.RADIX_MIN_LANES} "
          f"RADIX_PASS_SUBSTAGES={ops.RADIX_PASS_SUBSTAGES} "
          f"{'agree' if agree else 'DISAGREE'} with this run")
    # radix where substages > passes * RADIX_PASS_SUBSTAGES: at least
    # every width bitonic won, below every width radix won
    fit = max(1, math.ceil(fit_lo))
    table["fit"] = {"radix_pass_substages_from": fit,
                    "radix_pass_substages_below": fit_hi}
    print(f"[times] crossover: the model picks the faster family at every "
          f"width from 2^{ops.RADIX_MIN_LANES.bit_length() - 1} with "
          f"RADIX_PASS_SUBSTAGES in [{fit}, {fit_hi}) "
          f"({'an empty range' if fit >= fit_hi else 'fitted: ' + str(fit)})")
    faster_kv = [key for key, row in table.items()
                 if key != "fit" and row["radix_faster_kv"]]
    print(f"[times] crossover: radix sort_kv faster than the pair sort "
          f"(radix_faster_kv) at {faster_kv if faster_kv else 'no width'} "
          f"({smi})")
    return table


def e2e(label: str, fn, smi: str, reps: int = 5) -> dict:
    """Median host-clock time of ``fn`` ending in a synchronize."""
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print(f"[times] {label}: median {np.median(walls):.2f} ms of {reps} "
          f"(host clock + synchronize), peak memory {peak / 2**20:.1f} MiB "
          f"({smi})")
    return {"ms": walls, "median_ms": float(np.median(walls)),
            "max_memory_allocated_bytes": peak}


# ---------------------------------------------------------------------------
# alpha_k: the paper's k bounds on the t = 64 paths; the opt-in lenses
# ---------------------------------------------------------------------------

ALPHA_K_JOINS = ("statjoin_zipf", "statjoin_scalar_skew", "randjoin_zipf",
                 "randjoin_scalar_skew")
SMMS_R = 2                  # cluster.sort's default r, as the paths run it


def phase_alpha_k(smi: str) -> dict:
    """Every t = 64 sort of phases main and payload (SMMS r = 2 and
    Terasort, both kernel families) whose keys are distinct, held to its
    theorem's k bound: Theorem 2's 1 + 2/r + r t^3/n for SMMS, Theorem
    4's 5 + t^3/n for Terasort (``rep.check``: k_workload and k_network).
    A run above its bound is run again on the CPU: an equal report
    there makes it a finding about the bound at this size, recorded,
    and a different one a fault of the port, raised.  Then the t = 64
    joins on the paper's Zipf and scalar-skew tables: alpha 3 for
    StatJoin and 1 for RandJoin, StatJoin's k_out = max workload /
    (n_out / t) <= 2 (Theorem 6), and each report's k beside Theorem 7's
    / 5's 2 + t/sigma, sigma = n_out / n_in.  One JSON line carries
    every number."""
    n = T * M
    bounds = {"smms": smms_k_bound(n, T, SMMS_R),
              "terasort": terasort_k_bound(n, T)}
    sorts = []
    for label, algorithm, theorem, rep, on_cpu in SORT_REPORTS:
        row = {"path": label, "algorithm": algorithm, "distinct": theorem,
               "k_workload": rep.k_workload, "k_network": rep.k_network,
               "bound": bounds[algorithm]}
        if theorem:
            row["holds"] = rep.check(bounds[algorithm])
            if not row["holds"]:
                _same_report(f"{label} above its k bound, against the CPU",
                             rep, on_cpu())
                row["cpu_equal"] = True
            print(f"[alpha_k] {label:32s} k_workload {rep.k_workload:.4f} "
                  f"k_network {rep.k_network:.4f} against the bound "
                  f"{bounds[algorithm]:.4f}: "
                  f"{'held' if row['holds'] else 'ABOVE; the CPU equal'}")
        sorts.append(row)
    distinct = sum(theorem for _, _, theorem in sort_inputs(SEED).values())
    check(sum(r["distinct"] for r in sorts)
          == distinct * len(PATHS) * len(FAMILIES) * 2,
          "not every t = 64 sort of phases main and payload with distinct "
          "keys was held")
    joins = {}
    for name in ALPHA_K_JOINS:
        rep = JOIN_REPORTS[name]
        sigma = rep.n_out / max(1, rep.n_in)
        k_out = float(np.max(rep.workload) / (rep.n_out / rep.t))
        statjoin = JOINS[name].algorithm == "statjoin"
        if statjoin:
            bound = statjoin_k_bound(rep.t, sigma)
            check(rep.alpha == 3, f"{name}: alpha {rep.alpha} != 3")
            check(k_out <= 2.0, f"{name}: k_out {k_out} above 2 (Theorem 6)")
        else:
            bound = randjoin_k_bound(rep.t, sigma)
            check(rep.alpha == 1, f"{name}: alpha {rep.alpha} != 1")
        joins[name] = {"alpha": rep.alpha, "sigma": sigma, "k_out": k_out,
                       "k_workload": rep.k_workload,
                       "k_network": rep.k_network, "bound": bound,
                       "within": rep.check(bound)}
        print(f"[alpha_k] {name:24s} alpha {rep.alpha} sigma {sigma:.2f} "
              f"k_out {k_out:.4f} k_workload {rep.k_workload:.4f} "
              f"k_network {rep.k_network:.4f} against 2 + t/sigma "
              f"{bound:.4f} (Theorem {7 if statjoin else 5})"
              f": {'within' if joins[name]['within'] else 'above'} ({smi})")
    out = {"sorts": sorts, "joins": joins}
    print(json.dumps({"alpha_k": out}))
    return out


def phase_lenses(smi: str) -> dict:
    """The port's lenses on one SMMS sort at t = 64 x 65,536: the
    registry's ``kernel_dispatch_traces_total`` equals the dispatch
    counts of a call and doubles on a second identical call (the port
    dispatches on every call: the traces are the executions); a traced
    call holds one ``sync:`` span for each synchronizing operation that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports during it, and
    each of its spans is a ``repro:`` range in torch.profiler's trace of
    it; what ``obs.trace.span`` costs with neither sink on."""
    from repro_torch import obs
    x = sort_inputs(SEED)["uniform"][0]

    def traces():
        return {(dict(k)["op"], dict(k)["path"]): int(v) for k, v in
                obs.REGISTRY.counters_matching(
                    "kernel_dispatch_traces_total").items()}

    obs.reset_registry()
    before = collections.Counter(ops.DISPATCH_COUNTS)
    cluster.sort(x, algorithm="smms", device=DEVICE)
    cold = dict(collections.Counter(ops.DISPATCH_COUNTS) - before)
    check(traces() == cold, f"traces {traces()} != the dispatch counts "
                            f"{cold}")
    cluster.sort(x, algorithm="smms", device=DEVICE)
    check(traces() == {k: 2 * v for k, v in cold.items()},
          f"traces {traces()} after a second call, not twice {cold}")
    where = "cuda" if DEVICE == "cuda" else "plain"
    check(cold and all(path.endswith(where) for _, path in cold),
          f"the sort dispatched {cold}, not only to the card")

    tracer = obs.Tracer(enabled=True)
    with tracer.trace("q") as root:
        warned = sync_warnings(
            lambda: cluster.sort(x, algorithm="smms", device=DEVICE))
    spans = [s.name for s in root.walk()]
    syncs = [n for n in spans if n.startswith("sync:")]
    if warned is not None:
        check(warned == len(syncs), f"{warned} synchronizing operations "
                                    f"warned, {len(syncs)} sync: spans")
    with torch.profiler.profile() as prof:
        cluster.sort(x, algorithm="smms", device=DEVICE)
    ranges = collections.Counter(
        e.name[len(obs.trace.RANGE_PREFIX):] for e in prof.events()
        if e.name.startswith(obs.trace.RANGE_PREFIX)
        and not e.name.startswith(obs.trace.RANGE_PREFIX + "launch:"))
    # the traced call read the tape's counts for its phase spans too
    untraced = collections.Counter(n for n in spans[1:]
                                   if n != "sync:tape.counts")
    ranges.pop("sync:tape.counts", None)
    check(ranges == untraced, f"profiler ranges {dict(ranges)} != the "
                              f"traced call's spans {dict(untraced)}")

    def probe():
        with obs.trace.span("probe"):
            pass

    def bare():
        pass

    off_us = _per_call_us(probe) - _per_call_us(bare)
    out = {"dispatch_counts": {f"{op}/{path}": v
                               for (op, path), v in cold.items()},
           "sync_warnings": warned, "sync_spans": len(syncs),
           "spans": len(spans) - 1, "span_off_us": off_us}
    print(f"[lenses] traces counter {out['dispatch_counts']} cold, twice "
          f"that after a second call; {warned} synchronizing operations, "
          f"{len(syncs)} sync: spans ({collections.Counter(syncs)}); "
          f"{len(spans) - 1} spans a traced call, each a profiler range; "
          f"span() off {off_us:.3f} us a call ({smi})")
    return out


def sync_warnings(fn) -> Optional[int]:
    """Synchronizing CUDA operations ``fn()`` makes, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``; None off the card."""
    if DEVICE != "cuda":
        fn()
        return None
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


# ---------------------------------------------------------------------------
# examples: the port's entry points as a user starts them
# ---------------------------------------------------------------------------

EXAMPLE_RUNS = (("example_quickstart", "torch_quickstart", []),
                ("example_sort_cluster", "torch_sort_cluster", []),
                ("example_skew_join", "torch_skew_join", []),
                ("example_serve_requests", "torch_serve_requests", []),
                ("example_traced_query", "torch_traced_query", []),
                ("example_train_lm", "torch_train_lm", []),
                ("example_train_lm_full", "torch_train_lm",
                 ["--full", "--steps", "20"]))


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sorted_like_numpy(label: str, keys, x) -> None:
    got = np.asarray(keys.cpu() if isinstance(keys, torch.Tensor) else keys)
    want = np.sort(np.asarray(x).reshape(-1))
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          f"{label}: keys differ from np.sort of the input")


def _join_pairs_like_host(label: str, out, s, t) -> None:
    got = torch.sort(out.s_rows[out.valid].long() << 32
                     | out.t_rows[out.valid].long()).values.cpu()
    want = torch.sort(torch.from_numpy(host_pairs(
        np.asarray(s, np.int32), np.asarray(t, np.int32)))).values
    check(torch.equal(got, want), f"{label}: pairs differ from the host join")


def _cpu_join(s, t, algorithm: str):
    rows = np.arange(len(s))
    return cluster.join(s, rows, t, rows, algorithm=algorithm, t_machines=8,
                        device="cpu")[1]


def check_example(path: str, got: dict) -> None:
    """An example's outputs checked as tests/test_torch_examples.py checks
    them, against the host and the same calls on the CPU."""
    if path == "example_quickstart":
        x = lidar_like(8 * 4096, seed=0).reshape(8, 4096)
        keys, rep = got["smms"]
        _sorted_like_numpy(path, keys, x)
        _same_report(f"{path} smms", rep,
                     cluster.sort(x, algorithm="smms", device="cpu")[1])
        _sorted_like_numpy(f"{path} terasort", got["terasort"][0], x)
        s, t = scalar_skew_tables(4000, m_hot=400, n_hot=100, seed=1)
        for alg, (out, rep) in {**got["joins"], "auto": got["auto"]}.items():
            _join_pairs_like_host(f"{path} {alg}", out, s, t)
            if alg in DETERMINISTIC_JOINS:
                _same_report(f"{path} {alg}", rep, _cpu_join(s, t, alg))
    elif path == "example_sort_cluster":
        x = lidar_like(8 * (1 << 14), seed=3).reshape(8, 1 << 14)
        _sorted_like_numpy(path, got["keys"], x)
        _same_report(path, got["report"],
                     cluster.sort(x, algorithm="smms", device="cpu")[1])
        check(np.array_equal(got["keys_kernel"].view(np.int32),
                             got["keys_plain"].view(np.int32)),
              f"{path}: the kernels' keys differ from the plain versions'")
    elif path == "example_skew_join":
        for theta, run in got.items():
            s, t = zipf_tables(3000, 3000, theta=theta, seed=2, domain=150)
            for alg, (out, rep) in run["runs"].items():
                _join_pairs_like_host(f"{path} {theta} {alg}", out, s, t)
                if alg in DETERMINISTIC_JOINS:
                    _same_report(f"{path} {theta} {alg}", rep,
                                 _cpu_join(s, t, alg))
            check(run["auto_again"].query_plan.cached,
                  f"{path} {theta}: the second auto join missed the cache")
    elif path == "example_serve_requests":
        specs, results = got["queries"]["specs"], got["queries"]["results"]
        check(all(r.ok for r in results), f"{path}: a query failed")
        for spec, res in zip(specs, results):
            if spec.kind == "sort":
                _sorted_like_numpy(path, res.value[0], spec.arrays[0])
            else:
                s, _, t, _ = spec.arrays
                _join_pairs_like_host(path, res.value, s, t)
        llm = got["llm"]
        for tok in llm["tokens"]:
            check(tok.shape[1] == 4 and tok.min() >= 0
                  and tok.max() < llm["cfg"].vocab_size,
                  f"{path}: tokens out of range or of the wrong shape")
        # the same weights and left-padded batches through generate on
        # the CPU: the card's tokens must be the same (phase_serve_smoke's
        # rule, here at the example's batch and prompt sizes)
        on_cpu = tree_map(lambda w: w.cpu(), llm["params"])
        for toks, tok in zip(llm["batches"], llm["tokens"]):
            want = serve.generate(on_cpu, llm["cfg"], toks, max_new_tokens=4,
                                  device="cpu")
            check(np.array_equal(np.asarray(tok), np.asarray(want)),
                  f"{path}: card tokens != CPU tokens for a batch of "
                  f"{toks.shape}")
    elif path == "example_traced_query":
        res = got["result"]
        _sorted_like_numpy(path, res.value[0], uniform_keys(8 * 512, seed=5))
        check(res.report.query_plan.cached and got["stats"].served == 1,
              f"{path}: not the warm, planned query")
        check(os.path.getsize(got["trace_path"]) > 0, f"{path}: no trace")
        shutil.rmtree(os.path.dirname(got["trace_path"]), ignore_errors=True)
    else:                       # the two training runs
        losses, cfg, toks = got["losses"], got["cfg"], got["tokens"]
        head = max(1, min(10, len(losses) // 4))
        check(all(math.isfinite(v) for v in losses),
              f"{path}: a loss is not finite")
        check(np.mean(losses[-head:]) < np.mean(losses[:head]),
              f"{path}: the loss did not fall: {losses}")
        check(toks.shape == (2, 8) and toks.min() >= 0
              and toks.max() < cfg.vocab_size,
              f"{path}: tokens out of range or of the wrong shape")


@contextlib.contextmanager
def flash_held_to_plain(errs: list):
    """Every ``ops.flash_attention`` call while the block runs (the
    models call it through the module) also goes through
    ``flash_attention_plain`` on the same inputs, out of the launch
    counts; the kernel's output is held to it within FLASH_TOL and
    ``(shape, window, max abs err)`` appended to ``errs``."""
    real = ops.flash_attention

    def held(q, k, v, causal=True, window=None):
        out = real(q, k, v, causal=causal, window=window)
        with torch.no_grad():
            want = fa.flash_attention_plain(q, k, v, causal, window)
        rtol, atol = FLASH_TOL[q.dtype]
        a, b = out.detach().float(), want.float()
        err = max_abs_err(a, b)
        errs.append((tuple(q.shape), tuple(k.shape), window, err))
        check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
              f"flash_attention at q {tuple(q.shape)}, k {tuple(k.shape)}, "
              f"window {window}: kernel differs from its plain version "
              f"(max abs err {err})")
        return out

    ops.flash_attention = held
    try:
        yield errs
    finally:
        ops.flash_attention = real


def phase_examples(smi: str) -> dict:
    """Each ``examples/torch_*.py`` ``main()`` on the card, in-process,
    at its own sizes (``torch_sort_cluster`` makes its own NCCL group of
    one rank; ``torch_train_lm`` also with ``--full``: mamba2-130m at
    its published widths and depth, 20 steps), on its launch path, its
    outputs checked as its test checks them; the wall time of each."""
    out = {}
    for path, name, args in EXAMPLE_RUNS:
        main_fn = load_example(name).main
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash_errs: list = []
        with flash_held_to_plain(flash_errs):
            got = on_path(path, lambda: main_fn(args + ["--device", DEVICE]))
        wall = time.perf_counter() - t0
        check_example(path, got)
        out[path] = {"wall_s": wall}
        if "flash_attention" in PATH_KERNELS[path]:
            check(len(flash_errs) == PATH_LAUNCHES[path]["flash_attention"],
                  f"{path}: {len(flash_errs)} flash calls held, "
                  f"{PATH_LAUNCHES[path]['flash_attention']} launched")
            worst = max(e[3] for e in flash_errs)
            out[path]["flash_max_abs_err"] = worst
            print(f"[examples] {name}: {len(flash_errs)} flash_attention "
                  f"launches at {sorted({e[:3] for e in flash_errs})} each "
                  f"within FLASH_TOL of the plain version, max abs err "
                  f"{worst:.3g}")
        if "losses" in got:
            out[path].update(losses=got["losses"],
                             params=got["cfg"].param_count())
        print(f"[examples] {name} {' '.join(args)}: ok, {wall:.2f} s wall "
              f"({smi})")
    return out


def phase_launches() -> dict:
    """Every path launched exactly its kernels; kernel -> path -> count."""
    by_kernel = {name: {} for name in cuda.KERNELS}
    for path, want in PATH_KERNELS.items():
        got = {k: n for k, n in PATH_LAUNCHES[path].items() if n > 0}
        print(f"[launches] {path:24s} {got}")
        check(set(got) == want, f"path {path} launched {sorted(got)}, "
                                f"expected {sorted(want)}")
        for k, n in got.items():
            by_kernel[k][path] = n
    for name, paths in by_kernel.items():
        check(paths, f"kernel {name} was not launched on the main path")
    return by_kernel


def main() -> None:
    smi = phase_device()
    # full float32 matmuls (the gemma3 smoke run against the CPU); stated,
    # not left to the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = phase_build()
    dryrun_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dryruns = start_dryruns(dryrun_dir)
    rng = np.random.default_rng(SEED)
    errs = phase_kernels(rng)

    runs = {}
    for algorithm in PATHS:
        for phase, payload in ((phase_main, False), (phase_payload, True)):
            key = path_name(algorithm, payload, "bitonic")
            runs[key], twins = phase(smi, algorithm)
            runs[key + "_radix"], _ = phase(smi, algorithm, "radix", twins)
            del twins
    print(f"[main] the cost model picks {cost_model_family(M)} at "
          f"{M} lanes on this card; the other family ran forced")
    join_runs = phase_joins(smi)
    alpha_k = phase_alpha_k(smi)
    lenses = phase_lenses(smi)
    phase_small()
    phase_small_values_and_joins()
    phase_small_terasort()
    phase_small_radix()
    phase_c18()
    runs["bf16"] = phase_bf16(smi)
    runs["wide"] = phase_wide(smi)
    phase_nan_keys(errs)
    runs["staged"] = phase_staged(smi)
    runs["multiproc"] = phase_multiproc(smi, errs)
    runs["auto"] = phase_auto(smi)
    runs["serve_queries"] = phase_serve_queries(smi)
    runs["bucketize"] = phase_bucketize(smi)
    phase_serve_smoke()
    serving = phase_serve(smi)
    phase_serve_smoke(MOE_ARCH, "serve_granite_smoke")
    serving_moe = phase_serve_granite(smi)
    moe_runs = phase_moe_cluster(smi, errs)
    for arch, path, change in SMOKE_VARIANTS:
        phase_serve_smoke(arch, path, change)
    serving_rest = {"serve_pixtral": phase_serve_pixtral(smi),
                    "serve_mamba2": phase_serve_mamba2(smi),
                    "serve_jamba": phase_serve_jamba(smi)}
    training = {"flash_grad": phase_flash_grad(),
                "train_smoke": phase_train_smoke(),
                "train_gemma2b": phase_train(smi, TRAIN_ARCH, "train_gemma2b",
                                             TRAIN_B, TRAIN_STEPS),
                "train_mamba2": phase_train(smi, SSM_ARCH, "train_mamba2",
                                            TRAIN_SSM_B, TRAIN_SSM_STEPS),
                "bucketing": phase_bucketing(smi)}
    mesh = phase_mesh(smi, training["train_gemma2b"]["losses"],
                      serving["tokens"], dryruns, dryrun_dir)
    shutil.rmtree(dryrun_dir, ignore_errors=True)
    examples = phase_examples(smi)
    launches = phase_launches()

    times = phase_times(rng, smi)
    crossover = phase_crossover(smi)
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{cuda.SOURCES[k.library]}",
                "replaces": k.replaces,
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name],
                "max_abs_err": errs[name],
                "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                "library_ms": times[name]["library_ms"],
                **({"device_ms": times[name]["device_ms"]}
                   if "device_ms" in times[name] else {}),
                # the other key dtype's kernel at the same shape: bf16
                # for the sort side, the f32 CUDA-core kernel for attention
                "other_dtype": {key.split("@")[1]: {
                    f: times[key][f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms",
                                               "device_ms")
                    if f in times[key]}
                    for key in (f"{name}@bf16", f"{name}@f32")
                    if key in times},
                # the same kernel at other shapes: the paths' own
                # operands (the rank merge's landed rows), another window
                "shapes": {key.split("@")[1]: {
                    f: times[key][f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}
                    for key in times if key.startswith(name + "@")
                    and key.split("@")[1] not in ("bf16", "f32")}}
               for name, k in cuda.KERNELS.items()]
    print(json.dumps({"build": build, "runs": runs, "joins": join_runs,
                      "serve": serving, "serve_granite": serving_moe,
                      "moe": moe_runs, **serving_rest, **training,
                      "mesh": mesh, "alpha_k": alpha_k, "lenses": lenses,
                      "examples": examples, "times": times,
                      "crossover": crossover}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:      # a rank of phase_multiproc
        gloo_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
