"""The full-size configurations the chip smoke run and the profiler drive.

One table for both ``chip_smoke.py`` and :mod:`repro_torch.profile_port`:

* the sort: t = 64 machines x m = 65,536 float32 keys (n = 4,194,304),
  the widest row the kernels' gate admits, on four inputs
  (:func:`sort_inputs`), keys only and with a (t, m, 24) int32 payload
  (:func:`make_payload`: with the 4-byte key a 100-byte record, the sort
  benchmark's record size); and the small t = 8 x m = 4,096 whose
  receive rows fit one merge tile;
* the joins (:data:`JOINS`): the paper's §5.2 Zipf and scalar-skew
  tables at t = 64.
"""
from __future__ import annotations

import numpy as np
import torch

from .data import (lidar_like, scalar_skew_tables, uniform_keys, zipf_keys,
                   zipf_tables)

__all__ = ["T", "M", "T_SMALL", "M_SMALL", "JOIN_T", "PAYLOAD_COLS",
           "JOINS", "sort_inputs", "adversarial_shards", "make_payload"]

T, M = 64, 65536            # the main sort: n = 4,194,304 keys
T_SMALL, M_SMALL = 8, 4096  # receive rows that fit one merge tile
JOIN_T = 64
PAYLOAD_COLS = 24           # 4-byte key + 24 x 4-byte payload = 100 bytes

# name -> (algorithm, the two key columns); the paper's §5.2 inputs
JOINS = {
    "statjoin_zipf": ("statjoin", lambda: zipf_tables(
        1 << 17, 1 << 17, theta=0.5, seed=3)),
    "statjoin_scalar_skew": ("statjoin", lambda: scalar_skew_tables(
        1 << 20, 2048, 2048, seed=7)),
    "repartition_scalar_skew": ("repartition", lambda: scalar_skew_tables(
        1 << 20, 2048, 2048, seed=7)),
    "broadcast_zipf": ("broadcast", lambda: zipf_tables(
        1 << 14, 1 << 17, theta=0.5, seed=3)),
}


def sort_inputs(seed: int) -> dict:
    """name -> ((T, M) float32 keys, capacity attempts, Theorem 1 holds).

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
