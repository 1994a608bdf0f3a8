"""Frozen copies of the input generators the benchmark draws from.

Copies of ``repro_torch.data.synthetic`` (``uniform_keys``,
``zipf_tables``, ``zipf_keys``) and of
``repro_torch.workloads.make_payload``, kept here so that a change to
the program cannot move the benchmark's inputs.  The same seed gives the
same arrays as the program's own generators
(``portbench/tests/test_portbench_reference.py`` holds them equal).

Keys are drawn on the host with numpy, as the originals draw them; the
payload is drawn on the run's device by a ``torch.Generator`` in one
call.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["uniform_keys", "zipf_tables", "zipf_keys", "make_payload",
           "sub_seed"]


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed derived from ``seed`` (any whole number >= 0, also
    past 2**32) and an index path, for the i-th input of a pool."""
    return int(np.random.SeedSequence([int(seed), *map(int, path)])
               .generate_state(1, np.uint32)[0])


def uniform_keys(n: int, seed: int = 0, lo: float = 1.0,
                 hi: float = 12e6) -> np.ndarray:
    """Unique-ish uniform float keys in [lo, hi) (the paper's random sets)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=n).astype(np.float32)


def _zipf_pmf(domain: int, theta: float) -> np.ndarray:
    # Z(r) ~ 1 / r^(1-theta): theta=0 -> skewed, theta=1 -> uniform
    p = 1.0 / np.arange(1, domain + 1) ** (1.0 - theta)
    return p / p.sum()


def zipf_tables(n_s: int, n_t: int, theta: float, seed: int = 0,
                domain: int = 1000, key_base: int = 1000
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Two tables drawing join keys from the same Zipf(theta) distribution."""
    rng = np.random.default_rng(seed)
    p = _zipf_pmf(domain, theta)
    s = rng.choice(domain, size=n_s, p=p) + key_base
    t = rng.choice(domain, size=n_t, p=p) + key_base
    return s.astype(np.int32), t.astype(np.int32)


def zipf_keys(n: int, seed: int = 0, theta: float = 0.7,
              domain: int = 37) -> np.ndarray:
    """Skewed float32 sort keys: many ties and heavy hitters."""
    s, _ = zipf_tables(n, 1, theta=theta, seed=seed, domain=domain)
    return s.astype(np.float32)


def make_payload(t: int, m: int, seed: int, cols: int,
                 device="cuda") -> torch.Tensor:
    """(t, m, cols) int32 made on ``device`` from a seed; column 0 is the
    global row id (row-major), the rest random bits."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randint(0, 2**31 - 1, (t, m, cols), generator=g,
                      dtype=torch.int32, device=device)
    p[..., 0] = torch.arange(t * m, dtype=torch.int32,
                             device=device).reshape(t, m)
    return p
