"""Shared warmup + best-of-N timing.

Counterpart of ``src/repro/obs/timeit.py``.  The measured region is
``fn()`` and a wait for its result, timed with the same
``time.perf_counter`` clock the span tracer uses.  The reference waits
with ``jax.block_until_ready``, which blocks only JAX arrays (ROADMAP
C4); here the wait is ``torch.cuda.synchronize()`` on every CUDA
device a tensor of the result lies on, so a timed call ends when the
card has done its work, not when the host has queued it.

Best-of (not mean-of) is deliberate: the minimum is the least noisy
estimator of the warm path's cost.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Set

import torch

__all__ = ["TimeitResult", "timeit"]


@dataclasses.dataclass(frozen=True)
class TimeitResult:
    """Warm-path timing summary; all times in seconds."""
    best_s: float
    mean_s: float
    times_s: List[float]
    reps: int
    warmup: int
    last_result: Any = None

    @property
    def best_us(self) -> float:
        return self.best_s * 1e6

    @property
    def mean_us(self) -> float:
        return self.mean_s * 1e6


def _cuda_devices(out: Any, found: Set[torch.device], depth: int = 0) -> None:
    """Add the CUDA devices of the tensors in ``out`` (tuples, lists and
    dicts, a few levels deep) to ``found``."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif depth < 4 and isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found, depth + 1)
    elif depth < 4 and isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found, depth + 1)


def _block(out: Any) -> Any:
    """Wait until the card has finished the work behind ``out``."""
    found: Set[torch.device] = set()
    _cuda_devices(out, found)
    for dev in found:
        torch.cuda.synchronize(dev)
    return out


def timeit(fn: Callable[[], Any], *, reps: int = 5, warmup: int = 1,
           block: bool = True,
           setup: Optional[Callable[[], None]] = None) -> TimeitResult:
    """Best of ``reps`` timed calls after ``warmup`` untimed ones.

    ``fn`` takes no arguments (close over inputs).  ``setup`` runs
    before every *timed* rep, outside the clock -- use it to reset
    counters the measured call mutates.
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    out = None
    for _ in range(max(0, warmup)):
        out = fn()
        if block:
            out = _block(out)
    times: List[float] = []
    for _ in range(reps):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        out = fn()
        if block:
            out = _block(out)
        times.append(time.perf_counter() - t0)
    return TimeitResult(best_s=min(times),
                        mean_s=sum(times) / len(times),
                        times_s=times, reps=reps,
                        warmup=max(0, warmup), last_result=out)
