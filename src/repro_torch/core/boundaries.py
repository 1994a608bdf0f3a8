"""Algorithm 1 -- global bucket boundaries for SMMS (paper §3.1.1).

Counterpart of ``src/repro/core/boundaries.py``: per machine i, s+1
equi-depth samples lam[i, 0..s] of its sorted m objects; out come t+1
global boundaries b[0..t] such that every bucket [b_k, b_{k+1}) has an
estimated m objects.

* :func:`equidepth_samples` -- the samples, picked as the reference's
  jitted body picks them (index arithmetic in float32, as JAX runs with
  x64 off, by XLA's reciprocal, C18).
* :func:`interval_pdf` -- each machine's piecewise-constant density
  between its samples, the reference's own.
* :func:`boundaries` -- the reference's vectorised Algorithm 1
  (``boundaries_jax``): invert the summed piecewise-linear CDF.  Written
  with ``jnp.interp``'s own formula and ``jnp.linspace``'s as XLA
  evaluates them, in float32, summing the machines' CDFs in machine
  order: bitwise equal to the reference's boundaries for t <= 12 (see
  :func:`boundaries` for larger t).
* :func:`boundaries_oracle` -- the paper's priority-queue sweep, a
  numpy copy of the reference's oracle, for the tests.

Round 2 is replicated on every machine in the reference; every machine
computes the same boundaries from the same gathered samples, so the
port computes them once and shares the (t+1,) result.
"""
from __future__ import annotations

import heapq
import math
from typing import Tuple

import numpy as np
import torch

from ..kernels.bitonic import ftz
from ..numerics import float32_reciprocal, fma_float32
from ..obs import trace as obs_trace

__all__ = ["equidepth_samples", "interval_pdf", "boundaries",
           "boundaries_oracle"]


def equidepth_samples(sorted_local: torch.Tensor, s: int) -> torch.Tensor:
    """The s+1 equi-depth samples of each machine's sorted m objects.

    sorted_local: (..., m).  lam_0 = o_1 and lam_j = o_{ceil(j*m/s)}
    (1-indexed), per paper §3.1.  The quotient is the reference's as its
    jitted body computes it: XLA's CPU compiler turns ``j * m / s`` into
    float32(j*m) x float32(1/s), so where 1/s rounds up and j*m/s is a
    whole number the index comes out one higher (ROADMAP C18).  An index
    past the row (at j = s) takes ``jnp.take``'s fill: NaN for float
    rows, the dtype's minimum for integer ones.
    """
    m = sorted_local.shape[-1]
    dev = sorted_local.device
    j = torch.arange(1, s + 1, dtype=torch.int32, device=dev)
    quot = (j * m).to(torch.float32) * float32_reciprocal(s, dev)
    idx = torch.ceil(quot).to(torch.int64) - 1
    rest = sorted_local.index_select(-1, idx.clamp(max=m - 1))
    fill = (float("nan") if sorted_local.is_floating_point()
            else torch.iinfo(sorted_local.dtype).min)
    rest = torch.where(idx < m, rest, fill)
    return torch.cat([sorted_local[..., :1], rest], dim=-1)


def interval_pdf(lam: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """mu[i, j] = (m/s) / (lam[i, j+1] - lam[i, j]); mu[i, s] = 0.

    The reference's quotient in lam's dtype, ``(m / s) / max(width,
    1e-30)``, on lam's device.  The numerator is a tensor: on CUDA a
    Python scalar over a tensor computes reciprocal-times (ROADMAP C6).
    """
    width = lam[..., 1:] - lam[..., :-1]
    floor = torch.tensor(1e-30, dtype=width.dtype, device=width.device)
    mu = torch.full_like(width, m / s) / torch.maximum(width, floor)
    return torch.cat([mu, torch.zeros_like(mu[..., :1])], dim=-1)


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 in JAX's sort order on the comparator's classes:
    denormals and -0.0 fold onto +0.0 (XLA's CPU compare flushes them),
    the float order elsewhere, and every NaN above +inf."""
    b = v.view(torch.int32)
    b = torch.where((b & 0x7F800000) == 0, 0, b)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return torch.where(torch.isnan(v), torch.iinfo(torch.int32).max, b)


def _searchsorted_right(xp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(xp, x, side="right")``, probe for probe.

    JAX bisects exactly ``ceil(log2(K + 1))`` levels from (0, K) with
    ``mid = (low + high) // 2`` and goes left where ``x < xp[mid]`` in
    its sort order (:func:`_order_key`).  The keys-only network leaves a
    NaN inside a sorted row (ROADMAP C12), so Round 2's knot rows need
    not be monotone, and only this probe sequence gives the reference's
    interval there (C13).  xp: (..., K), x: (..., q) float32 with the
    same leading dims (or xp 1-D).  Returns (..., q) int64.  No host
    sync: six small ops a level.
    """
    k = xp.shape[-1]
    xk = _order_key(x.contiguous())
    xpk = _order_key(xp.contiguous()).expand(*xk.shape[:-1], k)
    low = torch.zeros(xk.shape, dtype=torch.int64, device=x.device)
    high = torch.full_like(low, k)
    for _ in range(math.ceil(math.log2(k + 1))):
        mid = (low + high) >> 1
        go_left = xk < xpk.gather(-1, mid)
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def _interp(x, xp, fp, left=None, right=None):
    """``jnp.interp(x, xp, fp, left, right)``, operation for operation.

    xp: (..., K) rows of knots, sorted but for NaN that the keys-only
    network left mid-row, with fp of the same shape (or (K,) shared);
    x: (..., q).  float32 throughout, with the update fused as XLA fuses
    it (:func:`~repro_torch.numerics.fma_float32`), and the intervals
    found by JAX's own bisection (:func:`_searchsorted_right`).
    """
    k = xp.shape[-1]
    fp = fp.expand(xp.shape)
    idx = _searchsorted_right(xp, x)
    i = torch.clamp(idx, 1, k - 1)
    fp_i, fp_im1 = fp.gather(-1, i), fp.gather(-1, i - 1)
    xp_i, xp_im1 = xp.gather(-1, i), xp.gather(-1, i - 1)
    df = fp_i - fp_im1
    dx = xp_i - xp_im1
    delta = x - xp_im1
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    q = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, fp_im1, fma_float32(q, df, fp_im1))
    left_v = fp[..., :1] if left is None else torch.full_like(f, left)
    right_v = fp[..., -1:] if right is None else torch.full_like(f, right)
    f = torch.where(x < xp[..., :1], left_v, f)
    f = torch.where(x > xp[..., -1:], right_v, f)
    return f


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num, dtype=float32)`` as XLA computes it.

    JAX writes ``start * (1 - step) + stop * step`` with ``step = iota /
    (num - 1)``; with start 0 XLA evaluates ``(stop * (1 / (num - 1))) *
    iota``, each product rounded to float32 (checked against the
    reference for many (stop, num)), then appends the stop itself.
    """
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / float(div)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    on_card = torch.device(device).type == "cuda"   # each copy blocks
    with obs_trace.sync("round2.linspace", on_card):
        step = (stop_t * recip).to(device)
    out = step * torch.arange(div, dtype=torch.float32, device=device)
    with obs_trace.sync("round2.linspace", on_card):
        stop_t = stop_t.to(device)
    return torch.cat([out, stop_t[None]])


def boundaries(lam: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """Vectorised Algorithm 1.  lam: (t, s+1) -> (t+1,) boundaries.

    F_i interpolates (lam[i, :], [0, m/s, ..., m]), 0 left of lam[i, 0]
    and m right of lam[i, s]; F = sum_i F_i is piecewise linear with
    knots at every sample, and b_k = F^{-1}(k m) is an interp in
    (F(knots), knots) space.
    """
    lam = lam.to(torch.float32)
    t = lam.shape[0]
    cgrid = _linspace(float(m), s + 1, lam.device)            # (s+1,)
    flat = lam.reshape(-1)
    knots = flat[torch.sort(ftz(flat), stable=True).indices]  # (t*(s+1),)
    per_machine = _interp(knots.expand(t, -1), lam, cgrid,
                          left=0.0, right=float(m))           # (t, K)
    # Summed in machine order.  XLA's CPU reduction keeps that order for
    # the small t the parity tests run; for larger t it vectorises the
    # sum across machines (eight lanes, or blocks of 32 rows), so the
    # reference's own boundaries move by a few float32 ulps with the
    # host's codegen, and the port matches them only that closely.
    f_at = per_machine[0]
    for i in range(1, t):
        f_at = f_at + per_machine[i]
    targets = torch.arange(1, t, dtype=torch.float32, device=lam.device) * m
    interior = _interp(targets, f_at, knots)
    return torch.cat([knots[:1], interior, knots[-1:]])


def boundaries_oracle(lam: np.ndarray, m: int, s: int) -> np.ndarray:
    """Paper Algorithm 1 via an explicit heap sweep.  lam: (t, s+1)."""
    lam = np.asarray(lam, dtype=np.float64)
    t = lam.shape[0]
    width = lam[:, 1:] - lam[:, :-1]
    mu = np.where(width > 0, (m / s) / np.maximum(width, 1e-300), 0.0)
    mu = np.concatenate([mu, np.zeros((t, 1))], axis=1)  # mu[:, s] = 0

    heap: list[Tuple[float, int, float]] = []
    nxt = np.zeros(t, dtype=np.int64)       # next[i]: next sample index to push
    pastpdf = np.zeros(t)                   # pdf contribution to retire
    for i in range(t):
        heapq.heappush(heap, (float(lam[i, 0]), i, float(mu[i, 0])))
        nxt[i] = 1

    out = [float(np.min(lam[:, 0]))]        # b_0 = global min sample
    pdf = 0.0
    pre = 0.0
    cur = 0.0
    flag = False
    while heap:
        lam_v, i, mu_v = heapq.heappop(heap)
        if not flag:
            # first pop: initialize the sweep origin, no mass before it
            pre = lam_v
            flag = True
        else:
            gain = (lam_v - pre) * pdf
            while cur + gain >= m and len(out) < t:
                # emit a boundary where the running estimated density hits m
                b = (m - cur) / pdf + pre if pdf > 0 else lam_v
                out.append(float(b))
                gain -= m - cur
                pre = b
                cur = 0.0
            cur += gain
            pre = lam_v
        pdf = pdf - pastpdf[i] + mu_v
        pastpdf[i] = mu_v
        if nxt[i] <= s:
            heapq.heappush(heap, (float(lam[i, nxt[i]]), i, float(mu[i, nxt[i]])))
            nxt[i] += 1
    last = float(np.max(lam[:, -1]))
    while len(out) < t:
        out.append(last)
    out.append(last)  # b_t = global max sample
    return np.asarray(out)
