"""Roofline terms for one NVIDIA H100 (SXM).

Counterpart of ``src/repro/launch/roofline.py``, with the H100's
constants in place of the TPU v5e's.  Terms per (arch x shape x mesh),
in seconds:

    T_compute = flops_per_device / PEAK_FLOPS
    T_memory  = hbm_bytes_per_device / HBM_BW
    T_coll    = collective_bytes_per_device / LINK_BW

The constants (NVIDIA's H100 SXM data sheet, dense rates, 700 W):

* ``PEAK_FLOPS`` = 989e12: bf16 on the tensor cores, without sparsity;
* ``HBM_BW`` = 3.35e12 bytes/s: 80 GB of HBM3;
* ``LINK_BW`` = 450e9 bytes/s: one direction of the card's NVLink 4
  (18 links of 25 GB/s a direction; the sheet's 900 GB/s counts both
  directions).

Every quantity that does not depend on the chip is the reference's:
``KernelCost``'s stream bytes, ``exchange_stage_bytes``'
buffers, ``model_flops`` and ``extrapolate``.  Only the times change.

``parse_collectives`` reads XLA's HLO text, which the port does not
have: an eager torch program has no compiled module to read.  Its
place is taken by :func:`tape_collectives`, which counts a
:class:`CollectiveStats` from a ``CollectiveTape``'s records: per
collective kind, the objects the busiest machine received, times the
bytes of an object (the tape records what landed, PAD-aware, where the
reference sums result buffers).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# ---- NVIDIA H100 SXM hardware model (per card) -----------------------------
PEAK_FLOPS = 989e12       # bf16 dense, tensor cores
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # bytes/s, NVLink 4, one direction

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CollectiveStats",
           "tape_collectives", "RooflineTerms", "ExchangeStage",
           "KernelCost", "exchange_stage_bytes", "model_flops",
           "extrapolate"]


@dataclasses.dataclass
class CollectiveStats:
    per_kind_bytes: Dict[str, float]

    @property
    def total(self) -> float:
        return sum(self.per_kind_bytes.values())


def tape_collectives(tape, t: int, bytes_per_obj: int = 4
                     ) -> CollectiveStats:
    """Per-device collective traffic of a batched run from its tape:
    for each kind (``"all-gather"``, ``"all-to-all"``, ``"record"``),
    the most objects any of the ``t`` machines received through it,
    times ``bytes_per_obj``."""
    return CollectiveStats({
        kind: float(recv.max()) * bytes_per_obj
        for kind, recv in tape.received_by_kind(t).items()})


# ---------------------------------------------------------------------------
# roofline assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    flops: float              # per device, whole step
    hbm_bytes: float          # per device
    coll_bytes: float         # per device
    model_flops: float        # 6*N*D (train) / 2*N_active*D (serve), global

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_coll(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    def useful_ratio(self, chips: int) -> float:
        """MODEL_FLOPS / (flops summed over chips)."""
        total = self.flops * chips
        return self.model_flops / total if total else 0.0

    def roofline_fraction(self, chips: int) -> float:
        """Fraction of the compute roofline the step achieves: useful
        model FLOPs per chip-second at the bottleneck step time."""
        t_step = max(self.t_compute, self.t_memory, self.t_coll)
        if t_step <= 0:
            return 0.0
        return (self.model_flops / chips) / (t_step * PEAK_FLOPS)

    def summary(self, chips: int) -> Dict[str, object]:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_coll,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_ratio(chips),
            "roofline_fraction": self.roofline_fraction(chips),
        }


@dataclasses.dataclass
class ExchangeStage:
    """One hop of a sort exchange, in the same units as RooflineTerms.

    ``receive_bytes`` is the static per-shard receive buffer the exchange
    allocates for this hop (its peak possible traffic -- the quantity the
    capacity theorems bound); ``fanin`` is how many peers contribute to
    it.
    """
    name: str
    fanin: int
    receive_bytes: int

    @property
    def t_link(self) -> float:
        """Hop time at link bandwidth if the buffer fills (upper bound)."""
        return self.receive_bytes / LINK_BW


@dataclasses.dataclass
class KernelCost:
    """Memory-traffic model for one sort-kernel dispatch.

    Sorting kernels are memory-bound, so the roofline term that matters
    is HBM traffic: ``bytes_hbm`` counts every full-array stream the
    kernel makes over its (rows, n) block in the reference's model of
    its TPU kernel, and ``t_memory`` prices it at the H100's HBM rate.
    ``row(elapsed_s)`` joins the model against a measured time.

    Stream models (per (rows, n) block, padded to np2 lanes):

    * **bitonic** -- every substage reads and writes the whole block:
      ``2 * elems * dtype_bytes * lg(np2)*(lg(np2)+1)/2``.
    * **radix** -- per pass: gather current keys bits (4 B), read the
      permutation (4 B), scatter it back (4 B); after the last pass one
      gather materializes keys + permutation (3 more 4 B streams).
    * **merge** -- ``ceil(lg t)`` pairwise merge levels, each a bitonic
      merge over the flat np2 block: ``2 * elems * dtype_bytes *
      ceil(lg t) * lg(np2_total)``.
    """
    kernel: str
    bytes_hbm: float

    @property
    def t_memory(self) -> float:
        """Elapsed-time floor at HBM bandwidth (seconds)."""
        return self.bytes_hbm / HBM_BW

    def achieved_bw(self, elapsed_s: float) -> float:
        """Effective bytes/s the measured run moved through the model."""
        return self.bytes_hbm / elapsed_s if elapsed_s > 0 else 0.0

    def row(self, elapsed_s: float, **extra) -> Dict[str, object]:
        """Expected-vs-achieved record of one measured call."""
        d = {"kernel": self.kernel,
             "bytes_hbm": round(self.bytes_hbm),
             "expected_t_memory_s": self.t_memory,
             "expected_bw_gb_s": HBM_BW / 1e9,
             "achieved_s": elapsed_s,
             "achieved_bw_gb_s": self.achieved_bw(elapsed_s) / 1e9,
             "bw_fraction": (self.t_memory / elapsed_s
                             if elapsed_s > 0 else 0.0)}
        d.update(extra)
        return d

    @staticmethod
    def _np2(n: int) -> int:
        return 1 if n <= 1 else 1 << (n - 1).bit_length()

    @classmethod
    def bitonic(cls, rows: int, n: int,
                dtype_bytes: int = 4) -> "KernelCost":
        np2 = cls._np2(n)
        logn = max(1, np2.bit_length() - 1)
        substages = logn * (logn + 1) // 2
        return cls("bitonic", 2.0 * rows * np2 * dtype_bytes * substages)

    @classmethod
    def radix(cls, rows: int, n: int, key_bits: int = 32,
              radix_bits: int = 4) -> "KernelCost":
        passes = -(-key_bits // radix_bits)
        per_pass = 3 * 4          # gather bits + read perm + scatter perm
        final = 3 * 4             # keys gather-out + perm write + bits read
        return cls("radix", float(rows * n) * (passes * per_pass + final))

    @classmethod
    def merge(cls, rows: int, n: int, dtype_bytes: int = 4) -> "KernelCost":
        total = cls._np2(rows * n)
        levels = max(1, (rows - 1).bit_length())
        logm = max(1, total.bit_length() - 1)
        return cls("merge", 2.0 * total * dtype_bytes * levels * logm)


def exchange_stage_bytes(t: int, m: int, *, topology: str = "flat",
                         cap_factor: float, bytes_per_obj: int = 4,
                         overlap_chunks: int = 2) -> List[ExchangeStage]:
    """Per-stage network bytes of the sort shuffle (flat or staged): the
    buffer arithmetic of the port's ``core/exchange.py``.
    ``topology="staged"`` with a ``t`` that does not factor is the flat
    single stage, as at run time."""
    from ..core.exchange import (flat_receive_capacity,
                                 staged_receive_capacities)
    from .mesh import factor_shards

    fs = factor_shards(t) if topology == "staged" else None
    if fs is None:
        cap = flat_receive_capacity(m, t, cap_factor)
        return [ExchangeStage("shuffle", t, cap * bytes_per_obj)]
    t1, t2 = fs
    cap1, cap2 = staged_receive_capacities(
        m, t1, t2, cap_factor, overlap_chunks=overlap_chunks)
    return [ExchangeStage("shuffle s1", t1, cap1 * bytes_per_obj),
            ExchangeStage("shuffle s2", t2, cap2 * bytes_per_obj)]


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for serving (D =
    tokens/step; MoE archs only compute their routed experts, so the
    *useful* FLOP baseline uses active params)."""
    if shape.kind == "train":
        d_tokens = shape.global_batch * shape.seq_len
        return 6.0 * cfg.active_param_count() * d_tokens
    if shape.kind == "prefill":
        d_tokens = shape.global_batch * shape.seq_len
        return 2.0 * cfg.active_param_count() * d_tokens
    d_tokens = shape.global_batch * 1
    return 2.0 * cfg.active_param_count() * d_tokens


def extrapolate(cost1: Dict[str, float], cost2: Dict[str, float],
                coll1: float, coll2: float, n_periods: int
                ) -> Tuple[float, float, float]:
    """total = M1 + (n_periods - 1) * (M2 - M1) for flops/bytes/coll."""
    f1, f2 = cost1.get("flops", 0.0), cost2.get("flops", 0.0)
    b1 = cost1.get("bytes accessed", 0.0)
    b2 = cost2.get("bytes accessed", 0.0)
    k = n_periods - 1
    return (f1 + k * (f2 - f1), b1 + k * (b2 - b1),
            coll1 + k * (coll2 - coll1))
