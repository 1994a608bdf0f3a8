"""RandJoin (paper §4.2): randomized skew equi-join on an a x b machine
matrix, batched over the t = a b machines on one card.

Counterpart of ``src/repro/core/randjoin.py`` (``choose_ab`` :42,
``route_to_interval`` :55, ``randjoin_shard`` :88, ``randjoin`` :128).
Machine (i, j) of the matrix is machine i*b + j.  Every S tuple draws a
row i in [0, a) and must reach the b machines (i, *); every T tuple
draws a column j and must reach the a machines (*, j).  Machine (i, j)
cross-products what it holds, so each (i, j) fragment pair is joined
exactly once.  Each side is one all_to_all along one axis of the grid,
which lands a tuple on its drawn line, and one all_gather along the
other, which replicates it across that line; all four hops and the
local join form ONE round (alpha 1).

The routing sorts each machine's tuples by their drawn line and cuts
them at 1..n-1 in one kernel (``ops.sort_partition_kv`` on the int32
draws, the fused pair sort), then packs the (n, C) tiles of the flat
exchange.  The draws are the caller's to give (``assignments``) or are
made from ``seed`` by a ``torch.Generator``: torch cannot reproduce the
reference's ``jax.random`` stream (ROADMAP C3).

Guarantee (Cor 3 / Thm 5): per-machine output < 2 MN/t per key w.p.
>= 1 - 1.2e-9 when M/a, N/b >= 300.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..cluster.collectives import CollectiveTape
from ..cluster.substrate import resolve_substrate
from ..kernels import ops
from .exchange import PAD, build_send_buffer, static_exchange
from .localjoin import MASKED_KEY, JoinOutput, local_equijoin

__all__ = ["choose_ab", "draw_assignments", "route_to_interval",
           "randjoin_shard", "randjoin"]


def choose_ab(t: int, size_s: int, size_t: int) -> Tuple[int, int]:
    """Pick (a, b) with a*b = t minimizing a|T| + b|S| (paper §4.2.1)."""
    best = None
    for a in range(1, t + 1):
        if t % a:
            continue
        b = t // a
        cost = a * size_t + b * size_s
        if best is None or cost < best[0]:
            best = (cost, a, b)
    return best[1], best[2]


def draw_assignments(t: int, ms: int, mt: int, a: int, b: int, seed: int,
                     device):
    """Each machine's draws: S tuples' rows (t, ms) in [0, a) and T
    tuples' columns (t, mt) in [0, b), int32, from a generator seeded
    from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    i_assign = torch.randint(0, a, (t, ms), generator=g, device=device)
    j_assign = torch.randint(0, b, (t, mt), generator=g, device=device)
    return i_assign.to(torch.int32), j_assign.to(torch.int32)


def route_to_interval(keys: torch.Tensor, rows: torch.Tensor,
                      assign: torch.Tensor, grid: Tuple[int, int], axis: int,
                      cap_pair: int, tape: CollectiveTape):
    """all_to_all every machine's tuples to their drawn line member.

    keys/rows/assign: (t, m) int32; ``assign`` in [0, n) with n =
    grid[axis].  Returns (join_keys, payload_rows, dropped, valid_count):
    (t, n*C), (t, n*C), (t,), (t,); masked slots have join key
    MASKED_KEY.  Integer boundaries 1..n-1 with the left rule cut the
    sorted draws where the reference's do.
    """
    t, m = keys.shape
    n = grid[axis]
    pairs = torch.stack([keys, rows], dim=-1)                  # (t, m, 2)
    interior = torch.arange(1, n, dtype=assign.dtype, device=assign.device)
    assign_sorted, payload, starts, lens = ops.sort_partition_kv(
        assign, pairs, interior)
    kbuf, vbuf, dropped = build_send_buffer(
        assign_sorted.to(torch.float32), starts, lens, cap_pair,
        values=payload)
    line = torch.arange(t, device=keys.device)
    me = line // grid[1] if axis == 0 else line % grid[1]   # place in the line
    sent = m - lens[line, me]
    rk, rv = static_exchange(kbuf, tape, sent, vbuf, grid=grid, axis=axis)
    rk = rk.reshape(t, -1)
    rv = rv.reshape(t, -1, 2)
    valid = rk < PAD
    jkeys = torch.where(valid, rv[..., 0], MASKED_KEY)
    jrows = torch.where(valid, rv[..., 1], 0)
    return jkeys, jrows, dropped, valid.sum(dim=1)


def randjoin_shard(s_keys, s_rows, t_keys, t_rows, i_assign, j_assign, *,
                   a: int, b: int, out_capacity: int,
                   in_cap_factor: float = 2.0,
                   tape: Optional[CollectiveTape] = None) -> JoinOutput:
    """The RandJoin body for all t = a*b machines: local fragments
    (t, ms), (t, mt) int32 and their draws, rows in [0, a) for S,
    columns in [0, b) for T."""
    ms, mt = s_keys.shape[1], t_keys.shape[1]
    grid = (a, b)
    if tape is None:
        tape = CollectiveTape()

    with tape.phase("map: route+replicate"):
        # S to its row (all_to_all within each column), then across it
        cap_s = max(1, math.ceil(in_cap_factor * ms / a))
        sk, sr, sdrop, s_count = route_to_interval(
            s_keys, s_rows, i_assign, grid, 0, cap_s, tape)
        sk = tape.all_gather(sk, count=s_count, grid=grid, axis=1)
        sr = tape.all_gather(sr, track=False, grid=grid, axis=1)

        # T to its column (all_to_all within each row), then down it
        cap_t = max(1, math.ceil(in_cap_factor * mt / b))
        tk, tr, tdrop, t_count = route_to_interval(
            t_keys, t_rows, j_assign, grid, 1, cap_t, tape)
        tk = tape.all_gather(tk, count=t_count, grid=grid, axis=0)
        tr = tape.all_gather(tr, track=False, grid=grid, axis=0)

        # the local cross product, in the same round
        t = a * b
        out = local_equijoin(sk.reshape(t, -1), sr.reshape(t, -1),
                             tk.reshape(t, -1), tr.reshape(t, -1),
                             out_capacity)
        dropped = out.dropped + tape.psum(sdrop + tdrop, grid=grid,
                                          axis=0 if a > 1 else 1)
    return out._replace(dropped=dropped.to(torch.int32))


def randjoin(s_keys: np.ndarray, s_rows: np.ndarray,
             t_keys: np.ndarray, t_rows: np.ndarray,
             t_machines: int, out_capacity: int,
             seed: int = 0, in_cap_factor: float = 2.0,
             ab: Optional[Tuple[int, int]] = None,
             assignments=None, device="cuda", substrate=None):
    """Deal the tables to the a x b machines and join them on ``device``.

    Tables are flat host arrays, dealt in order to the t machines (the
    paper's 'evenly distributed initially' assumption; the last rows
    padded with MASKED_KEY).  ``assignments=(i_assign, j_assign)``
    gives the draws, (t, ms) rows and (t, mt) columns, int32; None
    draws them from ``seed``.  Returns (JoinOutput, report), the
    output's fields (t, capacity) or (t,), machine-major as the port's
    other joins (the reference's are (a, b, ...), the same machines in
    the same order).  ``substrate``: a substrate of a x b machines, a
    provider (called with the reference's axes ``(("a", a), ("b",
    b))``) or None, the process-wide pool.
    """
    a, b = ab if ab is not None else choose_ab(
        t_machines, s_keys.shape[0], t_keys.shape[0])
    t = a * b

    def deal(keys, rows):
        n = keys.shape[0]
        pad = (-n) % t
        k = np.concatenate([np.asarray(keys, np.int32),
                            np.full(pad, MASKED_KEY, np.int32)])
        r = np.concatenate([np.asarray(rows, np.int32),
                            np.zeros(pad, np.int32)])
        return (torch.from_numpy(k.reshape(t, -1)).to(device),
                torch.from_numpy(r.reshape(t, -1)).to(device))

    sk, sr = deal(s_keys, s_rows)
    tk, tr = deal(t_keys, t_rows)
    if assignments is None:
        i_assign, j_assign = draw_assignments(t, sk.shape[1], tk.shape[1],
                                              a, b, seed, device)
    else:
        i_assign, j_assign = (torch.from_numpy(np.array(v, np.int32))
                              .to(device) for v in assignments)
        if i_assign.shape != sk.shape or j_assign.shape != tk.shape:
            raise ValueError(
                f"assignments of shapes {tuple(i_assign.shape)} and "
                f"{tuple(j_assign.shape)}; the dealt fragments are "
                f"{tuple(sk.shape)} and {tuple(tk.shape)}")

    body = functools.partial(randjoin_shard, a=a, b=b,
                             out_capacity=int(out_capacity),
                             in_cap_factor=float(in_cap_factor))
    sub = resolve_substrate(substrate, ("a", a), ("b", b))
    if sub.t != t:
        raise ValueError(f"{sub!r} runs {sub.t} machines; RandJoin's "
                         f"matrix has {a} x {b}")
    out, tape = sub.run(body, sk, sr, tk, tr, i_assign, j_assign)
    counts = out.count.cpu().numpy()
    n_in = s_keys.shape[0] + t_keys.shape[0]
    report = tape.report(algorithm=f"RandJoin(a={a},b={b})", t=t,
                         n_in=n_in, n_out=int(counts.sum()), workload=counts)
    return out, report
