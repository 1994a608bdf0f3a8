"""The one general generator: a configuration and a traffic mix (both
data files) in, the inputs of a run and its call out.

A configuration (``portbench/configs/<name>.json``) fixes the
deployment: the kind of operation, the machines, the data scale, the
record layout and the guarantees.  A traffic mix
(``portbench/traffic/<name>.json``) fixes what is sent: the key
distribution, the pool of distinct inputs the calls cycle through, and
the front door's arguments (``"call"``).  Inputs come from ``--seed``
alone: pool input i draws from :func:`~portbench.reference.generators.
sub_seed` (seed, i, ...), so the same seed gives the same inputs.

Sort keys live on the run's device, as a deployment keeps its records
there; join tables are host arrays, as ``cluster.join`` takes them.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench.reference import generators as gen
from portbench.reference.join import (capped_repartition_pairs,
                                      compare_join)
from portbench.reference.sort import (CONTROL_KEY_DTYPE, compare_sort,
                                      reference_sort)

__all__ = ["make_workload", "SortWorkload", "JoinWorkload"]

DTYPES = {"float32": torch.float32}


def _sort_keys(spec: Dict[str, Any], n: int, seed: int) -> np.ndarray:
    kind = spec["kind"]
    if kind == "uniform":
        return gen.uniform_keys(n, seed=seed)
    if kind == "zipf":
        return gen.zipf_keys(n, seed=seed, theta=spec["theta"],
                             domain=spec["domain"])
    raise ValueError(f"unknown sort key distribution {kind!r}")


def _join_tables(spec: Dict[str, Any], n_s: int, n_t: int, seed: int):
    kind = spec["kind"]
    if kind == "zipf":
        return gen.zipf_tables(n_s, n_t, theta=spec["theta"], seed=seed,
                               domain=spec["domain"],
                               key_base=spec["key_base"])
    raise ValueError(f"unknown join table distribution {kind!r}")


class SortWorkload:
    """``cluster.sort`` on (t, m) keys with a (t, m, cols) int32 payload
    (or none), both on the device."""
    op = "sort"

    def __init__(self, config, traffic, seed: int, device, front):
        self.front, self.device = front, torch.device(device)
        self.t, self.m = int(config["t_machines"]), int(config["m_per_machine"])
        self.cols = int(config.get("payload_cols", 0))
        dtype = DTYPES[config["key_dtype"]]
        self.options = dict(traffic.get("call", {}))
        self.pool: List[tuple] = []
        for i in range(int(traffic.get("pool", 2))):
            keys = _sort_keys(traffic["keys"], self.t * self.m,
                              gen.sub_seed(seed, i, 0))
            x = torch.from_numpy(keys.reshape(self.t, self.m)).to(
                self.device).to(dtype)
            v = (gen.make_payload(self.t, self.m, gen.sub_seed(seed, i, 1),
                                  self.cols, self.device)
                 if self.cols else None)
            self.pool.append((x, v, gen.sub_seed(seed, i, 2)))
        self.items_per_call = self.t * self.m
        self.input_bytes = self.t * self.m * (
            self.pool[0][0].element_size() + 4 * self.cols)

    def call(self, i: int):
        x, v, s = self.pool[i % len(self.pool)]
        return self.front.sort(x, values=v, seed=s, device=self.device,
                               **self.options)

    def answer(self, out):
        return out                      # (sorted keys, their payload rows)

    def check(self, i: int, answer) -> Dict[str, int]:
        x, v, _ = self.pool[i % len(self.pool)]
        return compare_sort(x, v, answer[0], answer[1])

    def control(self, i: int) -> Dict[str, int]:
        """The reference in the program's place, its keys compared in the
        precision below the configuration's."""
        x, v, _ = self.pool[i % len(self.pool)]
        keys, rows = reference_sort(x, v, CONTROL_KEY_DTYPE[x.dtype])
        return compare_sort(x, v, keys, rows)


class JoinWorkload:
    """``cluster.join`` of two int32 key columns with their row ids
    (``arange``), host arrays."""
    op = "join"

    def __init__(self, config, traffic, seed: int, device, front):
        self.front, self.device = front, torch.device(device)
        self.t = int(config["t_machines"])
        n_s, n_t = int(config["s_rows"]), int(config["t_rows"])
        self.options = dict(traffic.get("call", {}))
        self.pool = []
        for i in range(int(traffic.get("pool", 2))):
            s, t = _join_tables(traffic["tables"], n_s, n_t,
                                gen.sub_seed(seed, i, 0))
            self.pool.append((s, np.arange(n_s, dtype=np.int32), t,
                              np.arange(n_t, dtype=np.int32),
                              gen.sub_seed(seed, i, 2)))
        self.items_per_call = n_s + n_t
        self.input_bytes = (n_s + n_t) * 8      # an int32 key and row id

    def call(self, i: int):
        s, sr, t, tr, seed = self.pool[i % len(self.pool)]
        return self.front.join(s, sr, t, tr, t_machines=self.t, seed=seed,
                               device=self.device, **self.options)

    def answer(self, out):
        return (out.s_rows, out.t_rows, out.valid)

    def check(self, i: int, answer) -> Dict[str, int]:
        s, _, t, _, _ = self.pool[i % len(self.pool)]
        return compare_join(s, t, *answer)

    def control(self, i: int) -> Dict[str, int]:
        """The capped repartition join in the program's place."""
        s, _, t, _, _ = self.pool[i % len(self.pool)]
        codes = torch.from_numpy(capped_repartition_pairs(s, t, self.t)).to(
            self.device)
        n_t = len(t)
        return compare_join(s, t, codes // n_t, codes % n_t,
                            torch.ones_like(codes, dtype=torch.bool))


def make_workload(config, traffic, seed: int, device, front):
    kinds = {"sort": SortWorkload, "join": JoinWorkload}
    if config["op"] != traffic["op"]:
        raise ValueError(f"configuration {config['name']!r} is a "
                         f"{config['op']}, traffic a {traffic['op']}")
    return kinds[config["op"]](config, traffic, seed, device, front)
