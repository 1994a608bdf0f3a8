"""Whole runs of every cell on the CPU at a size a test holds: sound runs
come out correct; the control and every fault the cells can have come
out not correct; and a new cell is added by files and one entry alone.

The runs skip the look for a card (``run.py``'s) and drive the rest of
a run through ``harness.run_cell`` with ``device="cpu"``: the port's
plain kernels, its radix family forced for the sorts as the card runs
it at the cells' widths."""
import json
import pathlib
import shutil
import types

import numpy as np
import pytest
import torch

from portbench import control
from portbench.harness import (WARMUP_CALLS, Reservoir, forbidden_loaded,
                               run_cell)
from repro_torch import cluster
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The repository's benchmark with the join cell's entries added
    (``join_cell.json``): its files are all under portbench/ already."""
    top = tmp_path_factory.mktemp("bench")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((ROOT / "portbench/tests/join_cell.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] += extra[key]
    (top / "BENCHMARK.json").write_text(json.dumps(spec))
    (top / "portbench").symlink_to(ROOT / "portbench")
    return top
SORT_CELLS = ["sort.smms.gray_uniform", "sort.smms.gray_zipf",
              "sort.terasort.gray_uniform"]
JOIN_CELLS = ["join.statjoin.zipf"]
SMALL = {"sort": {"t_machines": 8, "m_per_machine": 2048},
         "join": {"t_machines": 64, "s_rows": 4096, "t_rows": 4096}}
SEED = 2**31 + 77


def _small(cell):
    return SMALL["join" if cell.startswith("join") else "sort"]


def _run(root, cell, front=None, trace=False, seed=SEED):
    with ops.force_sort_kernel("radix"):
        return run_cell(root, cell, seed, 0.2, trace, device="cpu",
                        front=front, config_overrides=_small(cell))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", SORT_CELLS + JOIN_CELLS)
def test_sound_runs_are_correct(root, cell, trace):
    res = _run(root, cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    if trace:
        assert "k_workload.sort" in names or "k_workload.join" in names
    else:
        assert "setup_s" in names
        assert ({"sort_Mrec_per_s", "sort_p95_ms"} <= names
                or "join_Mrow_per_s" in names)
    assert not forbidden_loaded()


@pytest.mark.parametrize("cell", SORT_CELLS + JOIN_CELLS)
def test_control_reads_incorrect(root, cell):
    for seed in (1, 2, 3):
        for i, kind, numbers in control.readings(
                root, cell, seed, program=True, device="cpu",
                config_overrides=_small(cell)):
            if kind == "control":
                assert max(numbers.values()) > 0, (seed, i, numbers)
            else:
                assert max(numbers.values()) == 0, (seed, i, numbers)


# -- the faults: the front door broken underneath the timed path ---------

def _sort_fault(kind):
    def sort(x, *, values=None, **kw):
        (keys, vals), rep = cluster.sort(x, values=values, **kw)
        t, m = x.shape
        if kind == "unchanged":              # the state handed back as it came
            return (x.reshape(-1), values.reshape(t * m, -1)), rep
        if kind == "half":                   # half of the machines left out
            (keys, vals), rep = cluster.sort(x[: t // 2],
                                             values=values[: t // 2], **kw)
            return (keys, vals), rep
        if kind == "no_exchange":            # each machine sorts its own row
            order = torch.sort(x, dim=1, stable=True).indices
            rows = torch.arange(t)[:, None]
            return (x[rows, order].reshape(-1),
                    values[rows, order].reshape(t * m, -1)), rep
        vals = vals.clone()                  # one answer altered
        vals[len(vals) // 2, 5] += 1
        return (keys, vals), rep
    return types.SimpleNamespace(sort=sort)


def _join_fault(kind):
    def join(s, sr, t, tr, *, t_machines, **kw):
        out, rep = cluster.join(s, sr, t, tr, t_machines=t_machines, **kw)
        if kind == "unchanged":              # rows handed back unjoined
            n = min(len(s), len(t))
            return out._replace(s_rows=torch.from_numpy(sr[:n]),
                                t_rows=torch.from_numpy(tr[:n]),
                                valid=torch.ones(n, dtype=torch.bool)), rep
        if kind == "half":                   # half of the machines' output
            valid = out.valid.clone()
            valid[t_machines // 2:] = False
            return out._replace(valid=valid), rep
        if kind == "no_exchange":            # machine i joins its own blocks
            si = np.arange(len(s)) * t_machines // len(s)
            ti = np.arange(len(t)) * t_machines // len(t)
            pairs = [(i, j) for i in range(len(s)) for j in
                     np.nonzero((t == s[i]) & (ti == si[i]))[0]]
            a = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
            b = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
            return out._replace(s_rows=a, t_rows=b,
                                valid=torch.ones(len(pairs), dtype=torch.bool)), rep
        t_rows = out.t_rows.clone()          # one answer altered
        first = torch.nonzero(out.valid.reshape(-1))[0]
        t_rows.view(-1)[first] = (t_rows.view(-1)[first] + 1) % len(t)
        return out._replace(t_rows=t_rows), rep
    return types.SimpleNamespace(join=join)


FAULTS = ["unchanged", "half", "no_exchange", "altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["sort.smms.gray_uniform",
                                  "sort.smms.gray_zipf",
                                  "sort.terasort.gray_uniform"])
def test_sort_faults_read_incorrect(root, cell, fault):
    res = _run(root, cell, front=_sort_fault(fault))
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("fault", FAULTS)
def test_join_faults_read_incorrect(root, fault):
    res = _run(root, "join.statjoin.zipf", front=_join_fault(fault))
    assert not res["correct"], (fault, res["checks"])


def test_a_failing_call_reads_incorrect(root):
    """Calls that raise once the warm-up is over: no answer comes."""
    calls = []

    def sort(*a, **kw):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("device lost")
        return cluster.sort(*a, **kw)
    res = _run(root, "sort.smms.gray_uniform",
               front=types.SimpleNamespace(sort=sort))
    assert not res["correct"] and res["failed"] == res["attempted"] > 0


def test_the_reservoir_draws_over_the_whole_window():
    """Each input's kept call is uniform over all of its calls: as often
    in the window's second half as in its first, and now and then in
    its last tenth."""
    calls, kept = 1000, []
    for seed in range(400):
        r = Reservoir(2**31 + seed, 2)
        for i in range(calls):
            r.offer(i, (WARMUP_CALLS + i) % 2, lambda: ("answer",))
        assert set(r.kept) == {0, 1}
        kept += [i for i, _ in r.kept.values()]
    late = sum(i >= calls // 2 for i in kept) / len(kept)
    assert 0.4 < late < 0.6
    assert sum(i >= 0.9 * calls for i in kept) > 0.05 * len(kept)


def test_a_fault_late_in_the_window_reads_incorrect(root):
    """Answers altered from the window's ninth call on: a check of the
    first calls alone would pass them.  The front door hands back each
    input's answer computed once, so the window holds thousands of
    calls."""
    done, count = {}, [0]

    def sort(x, *, values=None, **kw):
        count[0] += 1
        key = x.data_ptr()
        if key not in done:
            done[key] = cluster.sort(x, values=values, **kw)
        (keys, vals), rep = done[key]
        if count[0] > WARMUP_CALLS + 8:
            vals = vals.clone()
            vals[len(vals) // 2, 5] += 1
        return (keys, vals), rep
    with ops.force_sort_kernel("radix"):
        res = run_cell(root, "sort.smms.gray_uniform", SEED, 0.5, False,
                       device="cpu", front=types.SimpleNamespace(sort=sort),
                       config_overrides=_small("sort"))
    assert res["attempted"] > 200
    assert not res["correct"], res["checks"]


# -- a new cell by files and one entry ---------------------------------

def test_a_new_cell_needs_only_files_and_one_entry(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = tmp_path / "portbench"
    (pkg / "configs" / "tiny-sort.json").write_text(json.dumps({
        "name": "tiny-sort", "op": "sort", "key_dtype": "float32",
        "payload_cols": 0, "t_machines": 4, "m_per_machine": 1024}))
    (pkg / "traffic" / "terasort.zipf_wide.json").write_text(json.dumps({
        "op": "sort", "keys": {"kind": "zipf", "theta": 0.3, "domain": 5000},
        "pool": 3, "call": {"algorithm": "terasort"}}))
    (pkg / "metrics" / "sort_p50_ms.py").write_text(
        'UNIT = "ms"\n\n\ndef read(run):\n'
        '    lat = sorted(run.latencies_s)\n'
        '    return 1e3 * lat[len(lat) // 2] if lat else None\n')
    spec["configs"].append({"name": "tiny-sort", "source": "a test",
                            "file": "portbench/configs/tiny-sort.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "sort.terasort.tiny", "config":
                              "tiny-sort", "traffic": "terasort.zipf_wide",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:        # metrics that name their cells
        if "workloads" in m and m["name"].startswith("sort_"):
            m["workloads"].append("sort.terasort.tiny")
    spec["per_layer"].append({"name": "sort_p50_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "front door", "moves": "sort_p95_ms",
                              "workloads": ["sort.terasort.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run_cell(tmp_path, "sort.terasort.tiny", 5, 0.2, False,
                   device="cpu")
    assert res["correct"] and "sort_Mrec_per_s" in res["metrics"]
    assert set(res["checks"]) == {"keys_wrong", "answers_missing",
                                  "calls_failed"}
    res = run_cell(tmp_path, "sort.terasort.tiny", 5, 0.2, True, device="cpu")
    assert res["correct"] and "sort_p50_ms" in res["metrics"]
