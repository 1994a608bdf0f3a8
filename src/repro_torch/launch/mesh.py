"""The staged exchange's shard factorization.

A copy of the factorization half of ``src/repro/launch/mesh.py``
(``STAGED_AXIS_NAMES`` :20, ``factor_shards`` :23); the port imports
nothing of the reference package.  The shard
axis t is factored into t = t1 * t2 so one t-way all-to-all becomes
two ~sqrt(t)-way exchanges.  Only balanced power-of-two factorizations
are produced; anything else falls back to the flat topology with a
warning -- the staged path is an optimization, not a requirement.

The reference's ``staged_axes`` and device-mesh constructors
(``make_staged_mesh``, ``make_production_mesh``) belong to the
multi-process substrate (ROADMAP A7) and are not here: on one card the t machines are a batch
axis, and machine g = i1 * t2 + i2 sits at (i1, i2) of a (t1, t2) grid.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

__all__ = ["STAGED_AXIS_NAMES", "factor_shards"]

STAGED_AXIS_NAMES = ("i1", "i2")


def factor_shards(t: int, *, warn: bool = False
                  ) -> Optional[Tuple[int, int]]:
    """Balanced two-level factorization t = t1 * t2 (t1 >= t2 >= 2).

    Returns ``None`` when no balanced power-of-two factorization exists
    (t < 4, or t not a power of two) -- the caller falls back to the flat
    exchange.  ``warn=True`` announces that fallback (user-facing call
    sites pass it; probing call sites like the planner stay silent).
    """
    t = int(t)
    if t < 4 or (t & (t - 1)) != 0:
        if warn:
            warnings.warn(
                f"t={t} has no balanced power-of-two factorization; "
                "falling back to the flat (single-stage) exchange",
                stacklevel=2)
        return None
    k = t.bit_length() - 1
    return (1 << (k - k // 2), 1 << (k // 2))

