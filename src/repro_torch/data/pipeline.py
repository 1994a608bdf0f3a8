"""Deterministic, stateless-resumable data pipeline + SMMS length packing.

Counterpart of ``src/repro/data/pipeline.py``.

* :class:`TokenPipeline`: step -> batch is a pure function of (seed,
  step), so a restart needs no pipeline state in the checkpoint.  The
  draws come from a ``torch.Generator`` on the CPU seeded from (seed,
  step), so a run on the card and one on the CPU see the same batches;
  they are not the reference's ``jax.random`` draws (ROADMAP C3), and
  ``launch.train.train`` takes the reference's batches as ``pipeline=``
  where a test needs them.
* :func:`smms_length_bucketing`: documents grouped into t
  token-balanced buckets by the port's SMMS sort (``core.smms_sort`` on
  the lengths' device: Round 1's sorts, Round 3's search and merge).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..core import smms_sort

__all__ = ["TokenPipeline", "smms_length_bucketing"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Synthetic LM stream (zipf-ish unigram) for end-to-end training."""
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"}: (batch, seq_len) int32 CPU tensors, the
        labels the tokens shifted by one."""
        state = np.random.SeedSequence([self.seed, step]).generate_state(
            2, np.uint32)
        gen = torch.Generator().manual_seed(
            int(state[0]) << 32 | int(state[1]))
        # zipf-ish marginal: square a uniform to skew towards low ids
        u = torch.rand((self.batch, self.seq_len + 1), generator=gen)
        toks = (u * u * (self.vocab_size - 1)).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def smms_length_bucketing(lengths: np.ndarray, t_buckets: int, r: int = 2,
                          device=None):
    """Group documents into t token-balanced buckets via SMMS.

    lengths: (n,) document lengths (n % t == 0; a remainder is left
    out).  Returns (order, bucket_id, report): the document ids sorted
    by length (numpy int32), each position's bucket (numpy), and the
    sort's AlphaKReport.  Equal lengths are told apart by the
    reference's float32 tie-break, ``arange(n) * 1e-6`` added to the
    float32 lengths (two roundings, as its eager ops compute it).
    ``device``: None is the card, raising without one.
    """
    dev = resolve_device(device)
    n = len(lengths)
    m = n // t_buckets
    x = torch.from_numpy(np.asarray(lengths[:t_buckets * m]).reshape(
        t_buckets, m)).to(device=dev, dtype=torch.float32)
    ids = torch.arange(t_buckets * m, dtype=torch.int32,
                       device=dev).reshape(t_buckets, m)
    tie = ids.float() * torch.full((), 1e-6, dtype=torch.float32,
                                   device=dev)
    (_keys, order), report = smms_sort(x + tie, r=r, values=ids)
    bucket_id = np.repeat(np.arange(t_buckets),
                          [int(b) for b in report.workload])
    return order.cpu().numpy(), bucket_id, report
