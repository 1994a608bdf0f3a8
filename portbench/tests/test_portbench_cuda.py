"""The benchmark on the card: a short run of each cell through
``run.py``, untraced and traced.  Skips without a card.

    python -m pytest -q -m cuda portbench/tests/test_portbench_cuda.py
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(cell, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_on_the_card(card, cell):
    res = _run(cell, 0)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 3


@pytest.mark.cuda
def test_a_traced_run_reads_the_device(card):
    res = _run(CELLS[0], 1)
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert res["breakdown"]["device_ops"]
    roof = res["metrics"]["radix_sort_roofline.sort"]["value"]
    assert 0 < roof <= 105
