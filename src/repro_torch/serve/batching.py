"""Request batching with SMMS length bucketing + continuous batching.

A copy of ``src/repro/serve/batching.py`` (pure Python + numpy; the
port imports nothing of the reference package).

Serving pads every prompt in a batch to the longest member; batching
similar lengths together is a workload-balancing problem -- the same one
the paper's sorting solves.  The scheduler sorts queued prompt lengths
with SMMS (Algorithm-1 boundaries = token-balanced buckets) and emits
batches whose padding waste is bounded by the SMMS k-factor.

:class:`ContinuousBatcher` is the query engine's in-flight bucket
board: compatible requests are admitted into open buckets at any time,
and a bucket releases work the moment releasing is *worth it* rather
than at fixed ``batch_window_s`` boundaries -- a hot bucket keeps
draining back-to-back on its warm substrate while cold buckets age
out.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LengthBucketScheduler", "ContinuousBatcher"]


class LengthBucketScheduler:
    def __init__(self, max_batch: int = 8, buckets: int = 4):
        self.max_batch = max_batch
        self.buckets = buckets

    def plan(self, prompt_lengths: Sequence[int]
             ) -> List[List[int]]:
        """Group request indices into batches of similar length.

        Host-side Algorithm-1: sort the lengths, place the t-1 bucket
        boundaries at equal *token mass* (the equi-depth rule SMMS uses
        for its Round-2 boundaries) -- so every bucket holds ~total/t
        tokens and padding waste stays bounded by the SMMS k-factor.
        This is the serving dispatcher's hot path, so it runs as plain
        numpy on the queue snapshot.
        """
        n = len(prompt_lengths)
        if n == 0:
            return []
        lengths = np.asarray(prompt_lengths, np.float64)
        t = min(self.buckets, max(1, n // 2))
        order = np.argsort(lengths, kind="stable")
        if t > 1:
            csum = np.cumsum(lengths[order])
            targets = csum[-1] * (np.arange(1, t) / t)
            # side='right': mass landing exactly on a target closes the
            # bucket (a uniform queue splits evenly, not 1/2/2/3)
            cuts = np.searchsorted(csum, targets, side="right")
            bucket_id = np.searchsorted(cuts, np.arange(n), side="right")
        else:
            bucket_id = np.zeros(n, np.int64)
        # bucket_id[j] = bucket of the j-th SHORTEST request
        batches: List[List[int]] = []
        cur: List[int] = []
        cur_bucket = -1
        for idx, b in zip(order.tolist(), bucket_id.tolist()):
            if len(cur) >= self.max_batch or b != cur_bucket:
                if cur:
                    batches.append(cur)
                cur, cur_bucket = [], b
            cur.append(int(idx))
        if cur:
            batches.append(cur)
        return batches

    @staticmethod
    def padding_waste(prompt_lengths: Sequence[int],
                      batches: List[List[int]]) -> float:
        """Fraction of padded tokens across the plan (lower = better)."""
        lengths = np.asarray(prompt_lengths)
        total, useful = 0, 0
        for b in batches:
            mx = lengths[b].max()
            total += mx * len(b)
            useful += lengths[b].sum()
        return 1.0 - useful / max(total, 1)


class ContinuousBatcher:
    """In-flight bucket board: admit any time, release when worth it.

    One bucket per compatibility key (the engine's ``spec.bucket_key``).
    ``add()`` may be called at any moment; ``release(now)`` returns the
    groups that should dispatch *now*.  A bucket is due when any of:

    * it holds ``>= max_batch`` members (full -- nothing to wait for);
    * the board is **idle** (``release(idle=True)``): nothing is
      executing and the admission queue is drained, so lingering for
      ``window_s`` could only add latency, never batchmates;
    * the bucket is **hot** -- an execution for its key is in flight or
      finished within the last window: arrivals ride the warm substrate
      back-to-back instead of waiting for a window boundary;
    * its oldest member has aged ``window_s`` (cold buckets age out);
    * a member's deadline would pass before the age-out (release early
      rather than admit-then-expire).

    Oversized / mixed-size releases are split into ``<= max_batch``
    similar-length groups by :class:`LengthBucketScheduler`.  All
    clock values are passed in explicitly (``now``), which keeps the
    policy deterministic and directly unit-testable.
    """

    def __init__(self, max_batch: int = 8, window_s: float = 0.002,
                 scheduler: Optional[LengthBucketScheduler] = None):
        if max_batch < 1 or window_s < 0:
            raise ValueError("max_batch must be >= 1 and window_s >= 0")
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.scheduler = scheduler if scheduler is not None \
            else LengthBucketScheduler(max_batch=self.max_batch)
        # key -> [(item, size, deadline_at)] in arrival order
        self._buckets: "collections.OrderedDict[Hashable, list]" = \
            collections.OrderedDict()
        self._oldest: Dict[Hashable, float] = {}
        self._inflight: Dict[Hashable, int] = {}
        self._last_dispatch: Dict[Hashable, float] = {}

    # ---- board state --------------------------------------------------
    def add(self, key: Hashable, item: Any, size: int, now: float,
            deadline_at: Optional[float] = None) -> None:
        bucket = self._buckets.setdefault(key, [])
        if not bucket:
            self._oldest[key] = now
        bucket.append((item, int(size), deadline_at))

    def pending(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def mark_dispatched(self, key: Hashable, now: float) -> None:
        """An execution for ``key`` started: the bucket is hot."""
        self._inflight[key] = self._inflight.get(key, 0) + 1
        self._last_dispatch[key] = now

    def mark_done(self, key: Hashable) -> None:
        n = self._inflight.get(key, 0) - 1
        if n <= 0:
            self._inflight.pop(key, None)
        else:
            self._inflight[key] = n

    def inflight(self) -> int:
        return sum(self._inflight.values())

    # ---- release policy -----------------------------------------------
    def _hot(self, key: Hashable, now: float) -> bool:
        if self._inflight.get(key):
            return True
        last = self._last_dispatch.get(key)
        return last is not None and (now - last) < self.window_s

    def _due(self, key: Hashable, now: float, idle: bool) -> bool:
        bucket = self._buckets[key]
        if len(bucket) >= self.max_batch or idle or self._hot(key, now):
            return True
        if now - self._oldest[key] >= self.window_s:
            return True
        dl = min((d for _, _, d in bucket if d is not None), default=None)
        return dl is not None and dl <= now + self.window_s

    def release(self, now: float, *, idle: bool = False,
                flush: bool = False) -> List[Tuple[Hashable, List[Any]]]:
        """Pop and return every due bucket as ``(key, items)`` groups."""
        out: List[Tuple[Hashable, List[Any]]] = []
        for key in list(self._buckets):
            if not (flush or self._due(key, now, idle)):
                continue
            bucket = self._buckets.pop(key)
            self._oldest.pop(key, None)
            items = [it for it, _, _ in bucket]
            if len(items) <= 1:
                out.append((key, items))
                continue
            sizes = [s for _, s, _ in bucket]
            for idxs in self.scheduler.plan(sizes):
                out.append((key, [items[i] for i in idxs]))
        return out

    def next_deadline(self, now: float) -> Optional[float]:
        """Earliest instant some bucket becomes due (None when empty).

        Conservative (never later than the true due time): the
        dispatcher uses it as a wait bound, and an early wake only
        costs one no-op release scan.
        """
        best: Optional[float] = None
        for key, bucket in self._buckets.items():
            cand = self._oldest[key] + self.window_s
            dl = min((d for _, _, d in bucket if d is not None),
                     default=None)
            if dl is not None:
                cand = min(cand, dl)
            if self._hot(key, now) or len(bucket) >= self.max_batch:
                cand = now
            best = cand if best is None else min(best, cand)
        return best
