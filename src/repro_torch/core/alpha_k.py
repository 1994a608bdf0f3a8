"""(alpha, k)-minimality accounting: a copy of ``src/repro/core/alpha_k.py``.

An (alpha, k)-minimal algorithm on t machines runs in ``alpha``
synchronized rounds and bounds per-machine workload and network traffic
within a factor k of perfect balance.  The port's collective tape
records per-machine sent/received counts per round; this module turns
them into the paper's k values.  :func:`report_fields` flattens a
report into plain numpy fields so reports of both packages can be
compared field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np

__all__ = ["PhaseStats", "AlphaKReport", "smms_k_bound",
           "smms_workload_bound", "terasort_k_bound",
           "terasort_workload_bound", "statjoin_k_bound",
           "statjoin_workload_bound", "randjoin_k_bound",
           "merge_phase_stats", "report_fields"]


@dataclasses.dataclass(frozen=True)
class PhaseStats:
    """Per-device traffic of one synchronized round (collective phase)."""

    name: str
    sent: np.ndarray      # (t,) objects sent by each device this phase
    received: np.ndarray  # (t,) objects received by each device this phase

    @property
    def net(self) -> np.ndarray:
        return np.asarray(self.sent) + np.asarray(self.received)


@dataclasses.dataclass
class AlphaKReport:
    """Empirical (alpha, k) measurement for one algorithm execution."""

    algorithm: str
    t: int                      # number of machines
    n_in: int                   # input size (objects)
    n_out: int                  # output size (objects)
    workload: np.ndarray        # (t,) final per-device workload (objects)
    phases: List[PhaseStats] = dataclasses.field(default_factory=list)

    @property
    def alpha(self) -> int:
        return len(self.phases)

    @property
    def w_seq(self) -> float:
        return float(max(self.n_in, self.n_out))

    @property
    def n_total(self) -> float:
        return float(self.n_in + self.n_out)

    @property
    def k_workload(self) -> float:
        """max_i W_i / (W_seq / t) -- Ineq. (1)."""
        return float(np.max(self.workload) / (self.w_seq / self.t))

    @property
    def k_network(self) -> float:
        """max over phases of max_i N_i / (N / t) -- Ineq. (2)."""
        if not self.phases:
            return 0.0
        per_phase = [np.max(p.net) / (self.n_total / self.t)
                     for p in self.phases]
        return float(max(per_phase))

    @property
    def imbalance(self) -> float:
        """max workload / mean workload."""
        mean = float(np.mean(self.workload))
        return float(np.max(self.workload)) / mean if mean > 0 else float("inf")

    def check(self, k: float) -> bool:
        """Does this run satisfy (alpha, k)-minimality for the given k?"""
        return self.k_workload <= k and self.k_network <= k

    def summary(self) -> Dict[str, float]:
        return {
            "algorithm": self.algorithm,
            "alpha": self.alpha,
            "t": self.t,
            "k_workload": round(self.k_workload, 4),
            "k_network": round(self.k_network, 4),
            "imbalance": round(self.imbalance, 4),
        }


def smms_k_bound(n: int, t: int, r: int) -> float:
    """Theorem 2: SMMS is (3, 1 + 2/r + r t^3 / n)-minimal (needs t^3 <= n)."""
    return 1.0 + 2.0 / r + r * t**3 / n


def smms_workload_bound(n: int, t: int, r: int) -> float:
    """Theorem 1: round-3 workload <= (1 + 2/r + t^2/n) * m objects."""
    m = n / t
    return (1.0 + 2.0 / r + t**2 / n) * m


def terasort_k_bound(n: int, t: int) -> float:
    """Theorem 4: Terasort + Algorithm S is (3, 5 + t^3/n)-minimal w.h.p."""
    return 5.0 + t**3 / n


def terasort_workload_bound(n: int, t: int) -> float:
    """Theorem 3: |S_i| <= 5m + 1 with probability >= 1 - 1/n."""
    return 5.0 * (n / t) + 1.0


def statjoin_k_bound(t: int, sigma: float) -> float:
    """Theorem 7: StatJoin is (3, 2 + t/sigma)-minimal."""
    return 2.0 + t / sigma


def statjoin_workload_bound(w_total: int, t: int) -> float:
    """Theorem 6: join-result workload per machine <= 2 W / t."""
    return 2.0 * w_total / t


def randjoin_k_bound(t: int, sigma: float) -> float:
    """Theorem 5: RandJoin is (1, 2 + t/sigma)-minimal w.p. 1 - 1.2e-9."""
    return 2.0 + t / sigma


def merge_phase_stats(stats: Sequence[Mapping[str, np.ndarray]]
                      ) -> List[PhaseStats]:
    """PhaseStats from {'name', 'sent', 'received'} dicts."""
    return [PhaseStats(s["name"], np.asarray(s["sent"]),
                       np.asarray(s["received"])) for s in stats]


def report_fields(report) -> dict:
    """A report's comparable fields as plain Python / numpy values.

    Reads only attributes, so it takes the reference's reports too:
    algorithm, n_in, n_out, alpha, workload, k_workload, k_network, each
    phase's name, sent and received, and cap_factor and
    capacity_attempts (None where the run has no capacity loop, as
    StatJoin and repartition have none).
    """
    cap_factor = getattr(report, "cap_factor", None)
    attempts = getattr(report, "capacity_attempts", None)
    return {
        "algorithm": report.algorithm,
        "n_in": int(report.n_in),
        "n_out": int(report.n_out),
        "alpha": int(report.alpha),
        "workload": np.asarray(report.workload),
        "k_workload": float(report.k_workload),
        "k_network": float(report.k_network),
        "phases": [(p.name, np.asarray(p.sent), np.asarray(p.received))
                   for p in report.phases],
        "cap_factor": None if cap_factor is None else float(cap_factor),
        "capacity_attempts": None if attempts is None else int(attempts),
    }
