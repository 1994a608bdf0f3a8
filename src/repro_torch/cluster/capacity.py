"""Static receive capacities from theorem bounds + retry-on-overflow.

A copy of ``src/repro/cluster/capacity.py`` (the port imports nothing
of the reference package); each retry is a ``capacity_retry`` event on
the open trace span, as in the reference.

The exchange's receive tile is sized from the algorithm's workload
theorem (Theorem 1 for SMMS, Theorem 3 for Terasort, Theorem 6 for the
MoE dispatch's slots); an adversarial initial placement can
still overflow one (source, destination) pair, which the exchange
detects as dropped objects.  The recovery re-runs the deterministic
body with a geometrically larger factor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Tuple

from ..obs import trace as obs_trace

__all__ = ["CapacityPolicy", "CapacityOverflowError", "run_with_capacity"]


class CapacityOverflowError(RuntimeError):
    """Raised when the retry schedule is exhausted and objects still drop."""


@dataclasses.dataclass(frozen=True)
class CapacityPolicy:
    """Receive-capacity schedule: theorem-derived base, geometric growth.

    base_factor -- capacity as a multiple of m = n/t (the perfectly
    balanced share).
    """

    base_factor: float
    slack: float = 1.05
    growth: float = 2.0
    max_retries: int = 3

    def factors(self) -> Iterator[float]:
        f = self.base_factor * self.slack
        for _ in range(self.max_retries + 1):
            yield f
            f *= self.growth

    @property
    def first_factor(self) -> float:
        return self.base_factor * self.slack

    @classmethod
    def fixed(cls, factor: float, **kw) -> "CapacityPolicy":
        """A caller-chosen factor: no slack and no silent growth."""
        kw.setdefault("slack", 1.0)
        kw.setdefault("max_retries", 0)
        return cls(base_factor=float(factor), **kw)

    @classmethod
    def smms(cls, n: int, t: int, r: int, **kw) -> "CapacityPolicy":
        """Theorem 1: round-3 receive total <= (1 + 2/r + t^2/n) m."""
        return cls(base_factor=1.0 + 2.0 / r + t**2 / n, **kw)

    @classmethod
    def terasort(cls, n: int, t: int, **kw) -> "CapacityPolicy":
        """Theorem 3: |S_i| <= 5m + 1 w.p. >= 1 - 1/n."""
        m = max(1, n // t)
        return cls(base_factor=5.0 + 1.0 / m, **kw)

    @classmethod
    def randjoin(cls, **kw) -> "CapacityPolicy":
        """Cor. 3: per-machine output < 2 MN/t w.p. >= 1 - 1.2e-9."""
        return cls(base_factor=2.0, **kw)

    @classmethod
    def moe_dispatch(cls, **kw) -> "CapacityPolicy":
        """Theorem 6 applied to expert routing: the StatJoin slot plan
        splits a hot expert's tokens evenly over its replicas, so no slot
        receives more than 2 * T * K / n_slots assignments."""
        return cls(base_factor=2.0, **kw)


def run_with_capacity(attempt: Callable[[float], Tuple[object, int]],
                      policy: CapacityPolicy) -> Tuple[object, float, int]:
    """Run ``attempt(cap_factor) -> (result, dropped)`` until nothing drops.

    Each attempt is a ``capacity.attempt`` span (``attempt``,
    ``cap_factor`` and ``dropped``, the count the attempt read back;
    ``attempt`` may add its own attributes to it).  Returns ``(result,
    cap_factor_used, attempts)``.  Raises :class:`CapacityOverflowError`
    when the schedule is exhausted with drops remaining (the last result
    is attached as ``.last_result``).
    """
    attempts = 0
    result, dropped, factor = None, 0, policy.first_factor
    for factor in policy.factors():
        attempts += 1
        if attempts > 1:    # an actual retry (the first try is not one)
            obs_trace.event("capacity_retry", attempt=attempts,
                            cap_factor=float(factor), dropped=int(dropped))
        with obs_trace.span("capacity.attempt", attempt=attempts,
                            cap_factor=float(factor)) as sp:
            result, dropped = attempt(factor)
            dropped = int(dropped)
            if sp is not None:
                sp.attrs["dropped"] = dropped
        if dropped == 0:
            return result, factor, attempts
    err = CapacityOverflowError(
        f"{int(dropped)} objects still dropped after {attempts} attempts "
        f"(last cap_factor={factor:.3f})")
    err.last_result = result
    raise err
