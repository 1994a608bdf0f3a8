"""The full-size configurations the chip smoke run and the profiler drive.

One table for both ``chip_smoke.py`` and :mod:`repro_torch.profile_port`:

* the sorts: t = 64 machines x m = 65,536 float32 keys (n = 4,194,304),
  the widest row the bitonic tile reaches, on four inputs
  (:func:`sort_inputs`), keys only and with a (t, m, 24) int32 payload
  (:func:`make_payload`: with the 4-byte key a 100-byte record, the sort
  benchmark's record size), by SMMS and by Terasort
  (:data:`TERASORT_ATTEMPTS`); the small t = 8 x m = 4,096 whose
  receive rows fit one merge tile for both; and t = 64 x m = 262,144
  (:data:`M_WIDE`, n = 16,777,216), rows past the bitonic tile's reach;
* the joins (:data:`JOINS`): the paper's §5.2 Zipf and scalar-skew
  tables at t = 64, by StatJoin, RandJoin and the two baselines;
* the serving path: gemma3-12b at full width and depth (48 layers,
  d_model 3840, 16 q / 8 kv heads of 256, d_ff 15360, vocab 262,144),
  bf16, random weights from a seed; :data:`SERVE_B` prompts of
  :data:`SERVE_PROMPT` tokens (past the 1024-token window of its local
  layers) and :data:`SERVE_NEW` new tokens; and the same for the MoE
  decoder :data:`MOE_ARCH` (granite-moe-3b-a800m, 32 layers of 40
  experts, top-8: 3.30 G parameters, all of them on one card);
* the MoE dispatch (``cluster.moe_dispatch``): one MoE layer of
  :data:`MOE_ARCH` and one of :data:`MOE_WIDE_ARCH` (dbrx-132b, 16
  experts of 6144 x 10752, top-4: one layer's 6.3 GB of bf16 experts;
  the whole model's 263 GB does not fit a card) at full width, over
  :data:`MOE_T` machines, :data:`MOE_TOKENS` tokens each;
* the rest of the LM stack: :data:`VLM_ARCH` (pixtral-12b, 40 layers,
  d_model 5120, 256 front-end tokens of 1024) and :data:`SSM_ARCH`
  (mamba2-130m, 24 Mamba-2 layers) at full width and depth on the
  serving path's prompts, and mamba2-130m also on one prompt of
  :data:`SSM_LONG_PROMPT` tokens; :data:`HYBRID_ARCH`
  (jamba-1.5-large-398b) at full width cut to one attention and one
  mamba position (:func:`hybrid_cut`), :data:`HYBRID_B` prompt of
  :data:`HYBRID_PROMPT` tokens and :data:`HYBRID_NEW` new tokens;
* training (``launch.steps.build_train_step``): :data:`TRAIN_ARCH`
  (gemma-2b, 18 layers, d_model 2048, 8 q / 1 kv head of 256, d_ff
  16384, vocab 256,000: 2.51 G parameters) at full width and depth,
  bf16 weights, float32 AdamW moments, remat "full",
  :data:`TRAIN_B` x :data:`TRAIN_SEQ` tokens a step for
  :data:`TRAIN_STEPS` steps (the first a warm-up); :data:`SSM_ARCH`
  the same way at :data:`TRAIN_SSM_B` x :data:`TRAIN_SEQ` tokens (the
  reference's ``examples/train_lm.py`` default) for
  :data:`TRAIN_SSM_STEPS` steps;
* SMMS length bucketing (``data.smms_length_bucketing``):
  :data:`BUCKETS` buckets of :data:`BUCKET_DOCS` documents.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .data import (lidar_like, scalar_skew_tables, uniform_keys, zipf_keys,
                   zipf_tables)

__all__ = ["T", "M", "T_SMALL", "M_SMALL", "M_WIDE", "JOIN_T",
           "PAYLOAD_COLS",
           "SERVE_ARCH", "SERVE_B", "SERVE_PROMPT", "SERVE_NEW",
           "MOE_ARCH", "MOE_WIDE_ARCH", "MOE_T", "MOE_TOKENS",
           "VLM_ARCH", "SSM_ARCH", "SSM_LONG_PROMPT", "HYBRID_ARCH",
           "HYBRID_B", "HYBRID_PROMPT", "HYBRID_NEW", "hybrid_cut",
           "TRAIN_ARCH", "TRAIN_B", "TRAIN_SEQ", "TRAIN_STEPS", "TRAIN_LR",
           "TRAIN_WARMUP", "TRAIN_SSM_B", "TRAIN_SSM_STEPS", "BUCKETS",
           "BUCKET_DOCS",
           "JoinConfig", "JOINS", "TERASORT_ATTEMPTS", "sort_inputs",
           "adversarial_shards", "make_payload"]

T, M = 64, 65536            # the main sort: n = 4,194,304 keys
T_SMALL, M_SMALL = 8, 4096  # receive rows that fit one merge tile
M_WIDE = 1 << 18            # t = 64 rows past the bitonic tile's reach
JOIN_T = 64
PAYLOAD_COLS = 24           # 4-byte key + 24 x 4-byte payload = 100 bytes
SERVE_ARCH = "gemma3-12b"
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 2048, 16
MOE_ARCH = "granite-moe-3b-a800m"
MOE_WIDE_ARCH = "dbrx-132b"
MOE_T = 8
# tokens a layer call: granite's a prefill's 4 x 2048; dbrx's a quarter
MOE_TOKENS = {MOE_ARCH: 8192, MOE_WIDE_ARCH: 2048}
VLM_ARCH = "pixtral-12b"
SSM_ARCH = "mamba2-130m"
SSM_LONG_PROMPT = 32768     # one prompt, 128 chunks of 256
HYBRID_ARCH = "jamba-1.5-large-398b"
# one prompt: the dense alpha_k dispatch gathers every slot's weights at
# once, 32 slots x 3 x 8192 x 24576 bf16 = 38.6 GB beside 23.8 GB of
# weights
HYBRID_B, HYBRID_PROMPT, HYBRID_NEW = 1, 1024, 8
TRAIN_ARCH = "gemma-2b"
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2      # the cosine schedule's warm-up steps
TRAIN_SSM_B, TRAIN_SSM_STEPS = 8, 5
BUCKETS, BUCKET_DOCS = 64, 4096


def hybrid_cut(cfg):
    """jamba-1.5-large-398b at full width, its 72 layers cut to one
    period of two: position 0 attention with the dense FFN, position 1
    a Mamba-2 mixer with the MoE (~11.9 G parameters, 23.8 GB in bf16;
    the whole model's ~398 G do not fit a card)."""
    return dataclasses.replace(cfg, n_layers=2, period=2,
                               attn_positions=(0,))


class JoinConfig(NamedTuple):
    algorithm: str
    tables: Callable        # () -> (S key column, T key column)
    options: dict           # further keyword arguments of cluster.join


# name -> the join and its tables; the paper's §5.2 inputs.  RandJoin
# runs on an 8 x 8 machine matrix with route tiles twice each machine's
# fair share of a line (in_cap_factor 2.0, the reference core's default,
# kept from the slices whose kernels stopped at 2^16 lanes so that the
# Zipf run's widths, launches and times compare with theirs).  On scalar
# skew it takes the paper's 2^20-row tables, as StatJoin does: each
# machine's gathered S side is then 262,144 slots, past the bitonic
# tile's reach, and sorts by the radix family.
JOINS = {
    "statjoin_zipf": JoinConfig("statjoin", lambda: zipf_tables(
        1 << 17, 1 << 17, theta=0.5, seed=3), {}),
    "statjoin_scalar_skew": JoinConfig("statjoin", lambda: scalar_skew_tables(
        1 << 20, 2048, 2048, seed=7), {}),
    "randjoin_zipf": JoinConfig("randjoin", lambda: zipf_tables(
        1 << 17, 1 << 17, theta=0.5, seed=3), {"in_cap_factor": 2.0}),
    "randjoin_scalar_skew": JoinConfig("randjoin", lambda: scalar_skew_tables(
        1 << 20, 2048, 2048, seed=7), {"in_cap_factor": 2.0}),
    "repartition_scalar_skew": JoinConfig(
        "repartition", lambda: scalar_skew_tables(1 << 20, 2048, 2048,
                                                  seed=7), {}),
    "broadcast_zipf": JoinConfig("broadcast", lambda: zipf_tables(
        1 << 14, 1 << 17, theta=0.5, seed=3), {}),
}

# Terasort's capacity attempts on each of sort_inputs(), predicted
# before the first run at t=64 x 65,536: Theorem 3's first tile,
# C = ceil(5.5 m / t) = 5,633 slots a pair, holds every pair of them --
# the hot block's pair carries ~2,800 + 985 keys, and Zipf's hottest
# value ~3,900 keys from each sender.
TERASORT_ATTEMPTS = {"uniform": 1, "lidar_like": 1, "zipf": 1,
                     "adversarial": 1}


def sort_inputs(seed: int) -> dict:
    """name -> ((T, M) float32 keys, SMMS's capacity attempts, Theorem 1
    holds).

    The Zipf keys take 37 values: Theorem 1 assumes distinct keys, a
    heavy hitter's bucket receives ~3.7 m here, and its hottest pair
    (3942 keys at seed 0) needs the doubled tile -- one retry.
    """
    return {
        "uniform": (uniform_keys(T * M, seed=seed).reshape(T, M), 1, True),
        "lidar_like": (lidar_like(T * M, seed=seed).reshape(T, M), 1, True),
        "zipf": (zipf_keys(T * M, seed=seed).reshape(T, M), 2, False),
        "adversarial": (adversarial_shards(T, M, 2800, seed), 2, True),
    }


def adversarial_shards(t: int, m: int, hot: int, seed: int) -> np.ndarray:
    """Machine i aims a hot block at machine i+1, the rest dealt evenly.

    The keys are a uniform sample, so Algorithm 1's boundaries fall near
    the global quantiles; machine i holds ``hot`` keys from the middle of
    quantile slice i+1 plus m - hot keys dealt at random.  Pair
    (i, i+1) then carries ~hot + (m - hot)/t keys: past the first
    Theorem-1 tile (C = 2152 at t=64, m=65,536) but within the doubled
    one (4303), so exactly one capacity retry is needed.  A whole-shard
    placement (tests/test_capacity_retry.py) would overflow every tile
    of the retry schedule at this size.
    """
    rng = np.random.default_rng(seed)
    keys = np.sort(uniform_keys(t * m, seed=seed)).reshape(t, m)
    lo = (m - hot) // 2
    hot_blocks = keys[:, lo:lo + hot]
    rest = np.concatenate([keys[:, :lo], keys[:, lo + hot:]], axis=1)
    rest = rng.permutation(rest.reshape(-1)).reshape(t, m - hot)
    shards = np.concatenate([np.roll(hot_blocks, -1, axis=0), rest], axis=1)
    return np.ascontiguousarray(shards, dtype=np.float32)


def make_payload(t: int, m: int, seed: int, cols: int = PAYLOAD_COLS,
                 device="cuda") -> torch.Tensor:
    """(t, m, cols) int32 made on ``device`` from a seed; column 0 is the
    global row id, the rest random bits."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randint(0, 2**31 - 1, (t, m, cols), generator=g,
                      dtype=torch.int32, device=device)
    p[..., 0] = torch.arange(t * m, dtype=torch.int32,
                             device=device).reshape(t, m)
    return p
