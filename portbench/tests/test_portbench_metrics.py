"""The metric arithmetic on synthetic runs, the byte counts at the cells'
shapes, and the trace reduction on synthetic profiler events."""
import dataclasses
import json
import pathlib

import pytest
import torch

from portbench import devtrace, roofline
from portbench.harness import Bench, Run, p95

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = Bench(ROOT)


def _run(**kw):
    base = dict(cell={}, config={}, traffic={}, op="sort",
                setup_s=7.5, window_s=20.0,
                latencies_s=[0.02] * 1000, items_per_call=16_777_216,
                input_bytes=16_777_216 * 100, reports=[],
                memory_peak_bytes=None, held_bytes=0)
    base.update(kw)
    return Run(**base)


def test_p95_is_nearest_rank_over_all_calls():
    assert p95(list(range(1, 101))) == 95
    assert p95(list(range(1, 21))) == 19
    assert p95([5.0]) == 5.0
    assert p95([]) is None
    lat = [0.010] * 950 + [0.050] * 50
    assert p95(lat) == 0.010
    assert p95(lat + [0.05]) == 0.05


def test_rates_take_all_calls_over_all_the_window():
    run = _run(latencies_s=[0.02] * 1000, window_s=20.0)
    assert BENCH.reader("sort_Mrec_per_s").read(run) == pytest.approx(
        1000 * 16_777_216 / 20.0 / 1e6)
    assert BENCH.reader("join_Mrow_per_s").read(run) is None
    join = _run(op="join", items_per_call=262_144, latencies_s=[0.05] * 400)
    assert BENCH.reader("join_Mrow_per_s").read(join) == pytest.approx(
        400 * 262_144 / 20.0 / 1e6)
    lat = [0.015] * 900 + [0.030] * 100
    assert BENCH.reader("sort_p95_ms").read(_run(latencies_s=lat)) == \
        pytest.approx(30.0)


def test_peak_mem_ratio_leaves_out_the_held_answers():
    read = BENCH.reader("peak_mem_ratio").read
    assert read(_run()) is None                     # no card, no number
    run = _run(memory_peak_bytes=20_000_000_000, held_bytes=3_355_443_200,
               input_bytes=1_677_721_600)
    assert read(run) == pytest.approx((20e9 - 3_355_443_200) / 1_677_721_600)
    assert BENCH.reader("setup_s").read(run) == 7.5


def test_report_readers_take_the_mean():
    rep = [type("R", (), {"capacity_attempts": a, "k_workload": k})()
           for a, k in ((1, 1.0), (2, 3.0))]
    assert BENCH.reader("capacity_attempts.sort").read(
        _run(reports=rep)) == 1.5
    assert BENCH.reader("k_workload.sort").read(_run(reports=rep)) == 2.0
    assert BENCH.reader("k_workload.join").read(_run(reports=rep)) is None
    assert BENCH.reader("k_workload.join").read(
        _run(op="join", reports=rep)) == 2.0


def test_byte_counts_at_the_cells_shapes():
    cfg = json.loads((ROOT / "portbench/configs/paper-sort-100b.json")
                     .read_text())
    t, m = cfg["t_machines"], cfg["m_per_machine"]
    n = t * m
    assert n == 16_777_216 == cfg["records"]
    # Round 1's pair sort: float32 key + 24 int32 payload, in and out
    assert roofline.pair_sort_bytes(n, 4, 96) == 3_355_443_200
    # the merge: keys in, keys out, int32 order out
    assert roofline.merge_bytes(n, 4) == 201_326_592
    # the join's pair sort: int32 key + int32 row id, in and out
    assert roofline.pair_sort_bytes(1, 4, 4) == 16
    keys = torch.zeros(t, m)
    vals = torch.zeros(1, 1, 24, dtype=torch.int32).expand(t, m, 24)
    assert roofline.row_bytes(vals, keys.dim()) == 96
    mod = BENCH.reader("radix_sort_roofline.sort")
    valid, width = mod.bytes_of((keys, vals), {})
    assert int(valid) * width == 3_355_443_200
    tile = torch.full((1, t, t, m // t + 8), float("inf"))
    tile.view(-1)[:n] = 1.0
    valid, width = BENCH.reader("merge_roofline.sort").bytes_of(
        (tile,), {})
    assert int(valid) * width == 201_326_592
    del keys, tile
    frag = torch.full((64, 1000), torch.iinfo(torch.int32).max,
                      dtype=torch.int32)
    frag[:, :600] = 7
    valid, width = BENCH.reader("pair_sort_roofline.join").bytes_of(
        (frag, torch.zeros_like(frag)), {})
    assert int(valid) == 38_400 and width == 16
    assert roofline.roofline_pct(3.35e9, 0.004) == pytest.approx(25.0)
    assert roofline.roofline_pct(0, 1.0) is None
    assert roofline.roofline_pct(1.0, 0.0) is None


@dataclasses.dataclass
class _Ev:
    nm: str
    s: int
    e: int
    dev: bool = False
    corr: int = 0
    link: int = 0
    tid: int = 1
    ann: bool = False

    def name(self): return self.nm
    def start_ns(self): return self.s
    def end_ns(self): return self.e
    def correlation_id(self): return self.corr
    def linked_correlation_id(self): return self.link
    def start_thread_id(self): return self.tid
    def is_user_annotation(self): return self.ann

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.dev
                else torch.autograd.DeviceType.CPU)


def test_trace_reduction():
    """Busy and idle time, an entry's device time between its marks (its
    own kernels carry no correlation), and the idle gaps by host op."""
    entry = "repro_torch.kernels.ops:sort_kv"
    ev = [
        _Ev("spin_kernel", 0, 900, dev=True, link=99),
        _Ev(devtrace.CALL, 1000, 2000, corr=1),
        _Ev(devtrace.ENTRY + entry, 1100, 1400, corr=2),
        _Ev(devtrace.MARK, 1100, 1110, corr=9),
        _Ev("aten::fill_", 1102, 1108, corr=7),
        _Ev("aten::gather", 1150, 1200, corr=3),
        _Ev(devtrace.MARK, 1380, 1390, corr=10),
        _Ev("aten::fill_", 1382, 1388, corr=8),
        _Ev("fill", 1200, 1210, dev=True, link=7),           # the first mark
        _Ev("radix_pass", 1210, 1300, dev=True, link=0),     # no correlation
        _Ev("gather_kernel", 1300, 1400, dev=True, link=3),
        _Ev("fill", 1400, 1410, dev=True, link=8),           # the second mark
        _Ev("cudaLaunchKernel", 1160, 1170, link=3),         # runtime: skipped
        _Ev("aten::copy_", 1600, 1700, corr=4),
        _Ev("memcpy", 1700, 1800, dev=True, link=4),
        _Ev(devtrace.CALL, 2000, 3000, corr=5),
        _Ev("aten::nonzero", 2100, 2900, corr=6),
        _Ev("merge", 2500, 2600, dev=True, link=6),
        _Ev(devtrace.CALL, 2500, 2600, dev=True, ann=True),  # drawn on device
    ]
    tr = devtrace.reduce_events(ev)
    assert tr.window_s == pytest.approx(2000e-9)
    # 1200-1410, 1700-1800, 2500-2600
    assert tr.busy_s == pytest.approx(410e-9)
    assert tr.idle_pct == pytest.approx(79.5)
    assert tr.entry_device_s == {entry: pytest.approx(190e-9)}
    assert tr.device_events == 6
    assert dict(tr.device_ops)["radix_pass"] == pytest.approx(90e-9)
    gaps = dict(tr.idle_gaps)
    # 1000-1200 (mid 1100: the mark's range), 1410-1700 (mid 1555: the
    # call), 1800-2500 (mid 2150: aten::nonzero), 2600-3000 (2800: nonzero)
    assert gaps["aten::nonzero"] == pytest.approx(1100e-9)
    assert gaps[devtrace.MARK] == pytest.approx(200e-9)
    assert gaps[devtrace.CALL] == pytest.approx(290e-9)
    empty = devtrace.reduce_events([_Ev("k", 0, 1, dev=True, link=1)])
    assert empty.idle_pct is None and empty.device_events == 0
