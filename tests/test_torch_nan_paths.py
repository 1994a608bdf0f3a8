"""NaN keys through the port's front door, against the reference, on the CPU.

The keys-only bitonic network leaves a NaN inside a sorted row, in the
reference's Pallas kernel and in the port alike (ROADMAP C12).  Two
steps downstream depend on where it lands:

* SMMS Round 2 (``core/boundaries.py:_interp``) searches knot rows that
  hold such a NaN; the reference's ``jnp.interp`` finds each interval by
  JAX's fixed bisection in its sort order, NaN above +inf (C13);
* the payload gather after the argsort merge meets a pad's id among the
  first t*c places of the order, which JAX indexing clamps into the
  row (C14).

Each test holds the port bitwise against the reference: the
boundaries, ``_interp`` itself, and ``cluster.sort`` end to end with
and without values (keys, values, every report field), SMMS and
Terasort (with the reference's draws), the reference running its Pallas
kernels in interpret mode.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import cluster as jcluster
from repro.core.boundaries import boundaries_jax
from repro_torch import cluster
from repro_torch.kernels import ops

from test_torch_terasort import assert_reports_equal, reference_uniforms

# the module, not the function of the same name repro_torch.core exports
tb = importlib.import_module("repro_torch.core.boundaries")


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def nan_keys(case: str) -> np.ndarray:
    """(4, 64) float32 keys: the reproduction of C13/C14 (four NaN in
    row 1), NaN of both signs and payloads at a row's end and mid-row
    with -0.0, and no NaN at all.  No denormals: the reference's keys-only
    network flushes them on the CPU (ROADMAP C1), a divergence of its
    own."""
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    if case == "mid_row":
        x[1, 5:9] = np.nan
    elif case == "mixed":
        x[0, -1] = np.nan
        x.view(np.uint32)[2, 10] = 0xffc00123          # a negative NaN
        x.view(np.uint32)[3, 0] = 0x7fc00001           # a payload
        x[3, 1:4] = np.float32([-0.0, 0.0, -0.0])
    return x


CASES = ("mid_row", "mixed", "none")


# ---------------------------------------------------------------------------
# C13: Round 2 on knots that hold a NaN
# ---------------------------------------------------------------------------

def samples(where: str, t: int = 5, s: int = 8) -> np.ndarray:
    """(t, s+1) equi-depth samples, sorted, with a NaN where the keys-only
    network can leave one: mid-row, at a row's end, or nowhere."""
    rng = np.random.default_rng({"mid": 1, "end": 2, "none": 3}[where])
    lam = np.sort(rng.standard_normal((t, s + 1)).astype(np.float32), axis=1)
    if where == "mid":
        lam[1, 3] = np.nan
        lam[3, 1] = np.nan
    elif where == "end":
        lam[2, -1] = np.nan
    return lam


@pytest.mark.parametrize("where", ["mid", "end", "none"])
def test_round2_boundaries_match_reference_with_nan_knots(where):
    lam = samples(where)
    t, s1 = lam.shape
    m = 64
    want = boundaries_jax(jnp.asarray(lam), m, s1 - 1)
    got = tb.boundaries(torch.from_numpy(lam), m, s1 - 1)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("where", ["mid", "end", "none"])
def test_interp_matches_jnp_interp_on_unsorted_nan_knots(where):
    """``_interp`` against ``jnp.interp`` on each knot row, queries at
    every knot, between knots, past both ends and NaN."""
    lam = samples(where)
    fp = np.linspace(0.0, 64.0, lam.shape[1], dtype=np.float32)
    q = np.concatenate([np.sort(lam.reshape(-1)),
                        np.float32([-9.0, 9.0, 0.25, -0.0, 1e-40,
                                    np.nan, np.inf, -np.inf])])
    got = tb._interp(torch.from_numpy(q).expand(lam.shape[0], -1),
                     torch.from_numpy(lam), torch.from_numpy(fp),
                     left=0.0, right=64.0)
    for i, row in enumerate(lam):
        want = jnp.interp(jnp.asarray(q), jnp.asarray(row), jnp.asarray(fp),
                          left=0.0, right=64.0)
        np.testing.assert_array_equal(bits(got[i]), bits(want))


@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 64])
def test_searchsorted_right_replays_jax_bisection(k):
    """NaN of both signs, +-0, denormals and +-inf in unsorted rows of
    every length class around a power of two."""
    rng = np.random.default_rng(k)
    pool = np.float32([np.nan, -np.nan, 0.0, -0.0, 1e-40, -1e-40, np.inf,
                       -np.inf, 1.0, -1.0, 2.5])
    xp = rng.choice(pool, (3, k)).astype(np.float32)
    xp[:, : k // 2].sort(axis=1)
    q = np.tile(pool, (3, 1))
    got = tb._searchsorted_right(torch.from_numpy(xp), torch.from_numpy(q))
    for i in range(3):
        want = jnp.searchsorted(jnp.asarray(xp[i]), jnp.asarray(q[i]),
                                side="right")
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# C13 and C14 end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("algorithm", ["smms", "terasort"])
@pytest.mark.parametrize("case", CASES)
def test_cluster_sort_with_nan_keys_matches_reference(case, algorithm,
                                                      with_values):
    x = nan_keys(case)
    t, m = x.shape
    v = (np.arange(t * m, dtype=np.int32).reshape(t, m) * 7 + 3
         if with_values else None)
    (wk, wv), want = jcluster.sort(x, algorithm=algorithm, values=v, seed=0,
                                   kernel_backend="pallas")
    extra = ({"uniforms": reference_uniforms(0, t, m)}
             if algorithm == "terasort" else {})
    (gk, gv), got = cluster.sort(x, algorithm=algorithm, values=v, seed=0,
                                 device="cpu", **extra)
    np.testing.assert_array_equal(bits(gk), bits(wk))
    if with_values:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert_reports_equal(got, want)


def test_take_rows_clamps_as_jax_indexing():
    """Ids past the row and negative ids, as ``vflat[order]`` takes them."""
    vals = np.arange(2 * 5 * 3, dtype=np.int32).reshape(2, 5, 3)
    order = np.array([[7, -1, -9, 2, 4], [0, 5, 176, -5, 3]], np.int32)
    got = ops._take_rows(torch.from_numpy(vals), torch.from_numpy(order))
    for r in range(2):
        want = jnp.asarray(vals[r])[jnp.asarray(order[r])]
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
