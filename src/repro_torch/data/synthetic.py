"""Synthetic sort keys: numpy copies of ``src/repro/data/synthetic.py``.

* uniform random keys (the paper's random datasets);
* LIDAR-like clustered keys (mixture of Gaussians with power-law
  weights plus a uniform background);
* Zipf tables, and :func:`zipf_keys` -- skewed float keys with heavy
  hitters and duplicate Algorithm-1 boundaries, drawn as the
  reference's kernel-parity tests draw them
  (``tests/test_cluster_kernel_parity.py:23``);
* scalar-skew join tables (paper §5.2, after DeWitt et al.).

The same seed gives the same arrays as the reference's generators.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["uniform_keys", "lidar_like", "zipf_tables", "zipf_keys",
           "scalar_skew_tables"]


def uniform_keys(n: int, seed: int = 0, lo: float = 1.0,
                 hi: float = 12e6) -> np.ndarray:
    """Unique-ish uniform float keys in [lo, hi) (paper's random sets)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=n).astype(np.float32)


def lidar_like(n: int, seed: int = 0, clusters: int = 64) -> np.ndarray:
    """Clustered 1-D coordinates: mixture of Gaussians with power-law
    cluster weights + a uniform background -- mimics terrain-scan skew."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, clusters + 1) ** 1.2
    w /= w.sum()
    which = rng.choice(clusters, size=n, p=w)
    centers = rng.uniform(0, 1e6, size=clusters)
    scales = rng.uniform(1e2, 1e4, size=clusters)
    x = rng.normal(centers[which], scales[which])
    bg = rng.random(n) < 0.05
    x[bg] = rng.uniform(0, 1e6, bg.sum())
    return x.astype(np.float32)


def _zipf_pmf(domain: int, theta: float) -> np.ndarray:
    # Z(r) ∝ 1 / r^(1-theta): theta=0 -> skewed, theta=1 -> uniform
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


def scalar_skew_tables(n: int, m_hot: int, n_hot: int, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar-skew data (DeWitt et al. [7]): each table has n tuples,
    domain [n, 2n); hot key k0 = n occurs m_hot times in S, n_hot in T."""
    rng = np.random.default_rng(seed)
    s = rng.integers(n, 2 * n, size=n)
    t = rng.integers(n + 1, 2 * n, size=n)  # keep k0 exclusive to hot rows
    s[:m_hot] = n
    t[:n_hot] = n
    rng.shuffle(s)
    rng.shuffle(t)
    return s.astype(np.int32), t.astype(np.int32)
