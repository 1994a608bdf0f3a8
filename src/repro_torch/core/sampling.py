"""Algorithm S -- sequential draft sampling (Fan-Muller-Rezucha 1962),
batched over the t machines.

Counterpart of ``src/repro/core/sampling.py``.  Selects exactly q of a
machine's m objects, each subset equally likely (Lemma 1): object k
(0-based) is taken iff its uniform ``u_k < float32(q - j) /
float32(m - k)``, j being the count already taken.  The rule forces a
take when the remaining slots equal the remaining objects and takes
nothing past j = q.

The reference runs the rule as an m-step ``lax.scan`` that splits its
``jax.random`` key at every step and draws that step's uniform.  torch
cannot reproduce that stream (ROADMAP C3), so :func:`algorithm_s` takes
the (t, m) float32 uniforms as an argument: :func:`draw_uniforms` makes
them from a ``torch.Generator`` seeded from ``seed``, and the tests hand
it the reference's own draws instead.  Since exactly q objects are
taken, the scan runs as q vectorised passes: each finds, for every
machine at once, the first object after the last take whose uniform is
below its threshold.
"""
from __future__ import annotations

import math

import torch

__all__ = ["terasort_sample_count", "draw_uniforms", "algorithm_s"]


def terasort_sample_count(n: int, t: int) -> int:
    """q = ceil(ln(n*t)) samples per machine (Tao et al. setting)."""
    return max(1, math.ceil(math.log(n * t)))


def draw_uniforms(t: int, m: int, seed: int, device) -> torch.Tensor:
    """(t, m) float32 uniforms in [0, 1) from a generator seeded from
    ``seed`` on ``device`` (a CPU and a CUDA generator give different
    streams)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand((t, m), generator=g, dtype=torch.float32,
                      device=device)


def algorithm_s(x: torch.Tensor, q: int,
                uniforms: torch.Tensor) -> torch.Tensor:
    """Select exactly q values of each row of x (t, m), in position order.

    ``uniforms`` (t, m) float32 are the per-object draws.  Returns
    (t, q); when q >= m, x itself.
    """
    t, m = x.shape
    if q >= m:
        return x
    k = torch.arange(m, device=x.device)
    # thresholds[j, k] = float32(q - j) / float32(m - k): a division of
    # two tensors, as the reference divides (not by a reciprocal)
    slots = (q - torch.arange(q, device=x.device)).to(torch.float32)
    thresholds = slots[:, None] / (m - k).to(torch.float32)[None, :]
    last = torch.full((t, 1), -1, dtype=torch.long, device=x.device)
    picks = []
    for j in range(q):
        take = (uniforms < thresholds[j]) & (k > last)
        last = take.to(torch.int8).argmax(dim=1, keepdim=True)  # first take
        picks.append(last)
    return torch.gather(x, 1, torch.cat(picks, dim=1))
