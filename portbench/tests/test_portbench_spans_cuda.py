"""The program's spans on the card: a short traced run of each cell
through ``run.py`` prints every span metric.  Skips without a card.

    python -m pytest -q -m cuda portbench/tests/test_portbench_spans_cuda.py
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SPAN_METRICS = [m["name"] for m in SPEC["per_layer"]
                if m["source"] == "program_span"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_every_span_metric(card, cell):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(SPAN_METRICS) <= set(got), sorted(got)
    assert got["host_syncs.sort"]["value"] >= 1
    assert 0 <= got["retry_waste_pct.sort"]["value"] < 100
