"""The span reduction on synthetic profiler events: device busy and idle
time by the program's spans, the ctypes kernels' uncorrelated events
put down to their launch ranges, and the device reduction unmoved."""
import dataclasses

import pytest

from portbench import devtrace, spantrace
from portbench.harness import Bench
from test_portbench_metrics import ROOT, _Ev, _run

CALL, P = devtrace.CALL, spantrace.PREFIX


def _ns(d):
    return {k: round(v * 1e9) for k, v in d.items()}


def _events():
    """Two calls.  The first: the front door, one attempt with Round 1
    (a gather, then the radix launch), Round 2 (no device work) and
    Round 3 (two launches back to back, then a copy), then a host read.
    The second: a dropped attempt (two launches) and a second one (one
    launch).  Each launch fills its marker first; its kernels carry no
    correlation."""
    ev = [
        _Ev(CALL, 1000, 3000, corr=1),
        _Ev(P + "cluster.sort", 1010, 2990, corr=2),
        _Ev(P + "capacity.attempt", 1020, 2500, corr=3),
        _Ev(P + "phase:round1->2 samples", 1030, 1500, corr=4),
        _Ev("aten::gather", 1040, 1060, corr=5),
        _Ev(P + "launch:radix_sort", 1300, 1310, corr=6),
        _Ev("aten::fill_", 1302, 1305, corr=30),
        _Ev(P + "phase:round2 boundaries", 1500, 1550, corr=7),
        _Ev(P + "phase:round3 shuffle", 1550, 2400, corr=8),
        _Ev(P + "launch:merge_ranks", 1600, 1610, corr=9),
        _Ev("aten::fill_", 1602, 1605, corr=31),
        _Ev(P + "launch:merge_ranks_replay", 1620, 1630, corr=10),
        _Ev("aten::fill_", 1622, 1625, corr=32),
        _Ev("aten::copy_", 1700, 1720, corr=11),
        _Ev(P + "sync:collect.keys", 2600, 2700, corr=12),
        _Ev("aten::nonzero", 2610, 2690, corr=13),
        _Ev("cudaLaunchKernel", 1045, 1050, link=5),      # runtime: skipped
        # the device, in its own order
        _Ev("gather_kernel", 1100, 1200, dev=True, link=5),
        _Ev("fill", 1310, 1320, dev=True, link=30),
        _Ev("radix_pass", 1320, 1400, dev=True),
        _Ev("radix_pass", 1400, 1450, dev=True),
        _Ev("fill", 1645, 1650, dev=True, link=31),
        _Ev("merge_level", 1650, 1800, dev=True),
        _Ev("fill", 1800, 1802, dev=True, link=32),
        _Ev("replay", 1802, 1810, dev=True),
        _Ev("copy", 1810, 1900, dev=True, link=11),
        _Ev("nonzero", 2650, 2660, dev=True, link=13),
        # second call
        _Ev(CALL, 3000, 4000, corr=20),
        _Ev(P + "cluster.sort", 3010, 3990, corr=21),
        _Ev(P + "capacity.attempt", 3020, 3300, corr=22),
        _Ev(P + "launch:radix_sort", 3030, 3040, corr=23),
        _Ev("aten::fill_", 3032, 3035, corr=33),
        _Ev(P + "launch:merge_ranks", 3050, 3060, corr=24),
        _Ev("aten::fill_", 3052, 3055, corr=34),
        _Ev(P + "sync:dropped", 3200, 3290, corr=27),
        _Ev(P + "capacity.attempt", 3300, 3900, corr=25),
        _Ev(P + "launch:radix_sort", 3310, 3320, corr=26),
        _Ev("aten::fill_", 3312, 3315, corr=35),
        _Ev(P + "sync:dropped", 3800, 3890, corr=28),
        _Ev("fill", 3040, 3041, dev=True, link=33),
        _Ev("radix_pass", 3041, 3045, dev=True),
        _Ev("radix_pass", 3045, 3055, dev=True),
        _Ev("fill", 3060, 3061, dev=True, link=34),
        _Ev("merge_level", 3061, 3100, dev=True),
        _Ev("merge_level", 3100, 3150, dev=True),
        _Ev("fill", 3399, 3400, dev=True, link=35),
        _Ev("radix_pass", 3400, 3500, dev=True),
        _Ev("spin_kernel", 0, 900, dev=True, link=99),
        _Ev(CALL, 1200, 1300, dev=True, ann=True),   # drawn on the device
    ]
    return ev


FRONT = ("cluster.sort",)
ATT = FRONT + ("capacity.attempt",)
R1 = ATT + ("phase:round1->2 samples",)
R3 = ATT + ("phase:round3 shuffle",)


def test_busy_and_idle_by_span_add_up_to_the_trace():
    ev = _events()
    st = spantrace.reduce_spans(ev)
    tr = devtrace.reduce_events(ev)
    assert _ns(st.busy) == {
        R1: 100,                                    # the gather
        R1 + ("launch:radix_sort",): 10 + 130,      # marker, two kernels
        R3 + ("launch:merge_ranks",): 5 + 150,
        R3 + ("launch:merge_ranks_replay",): 2 + 8,
        R3: 90,                                     # the copy
        FRONT + ("sync:collect.keys",): 10,
        ATT + ("launch:radix_sort",): 15 + 101,     # both attempts
        ATT + ("launch:merge_ranks",): 90,
    }
    # busy: the union of the device events, as devtrace counts it
    assert round(tr.busy_s * 1e9) == 711
    assert sum(_ns(st.busy).values()) == 711
    # idle: every gap of the window, split where the host's span changes
    # (1450-1645 spans Round 1's end, Round 2, Round 3 and two launches)
    assert _ns(st.idle) == {
        spantrace.NO_SPAN: 40,
        FRONT: 10 + 100 + 290 + 10 + 90,
        ATT: 10 + 100 + 10 + 50 + 10 + 10 + 79 + 300 + 10,
        R1: 70 + 100 + 50,
        R1 + ("launch:radix_sort",): 10,
        ATT + ("phase:round2 boundaries",): 50,
        R3: 50 + 10 + 15 + 500,
        R3 + ("launch:merge_ranks",): 10,
        R3 + ("launch:merge_ranks_replay",): 10,
        FRONT + ("sync:collect.keys",): 50 + 40,
        ATT + ("launch:radix_sort",): 10 + 10,
        ATT + ("launch:merge_ranks",): 5,
        ATT + ("sync:dropped",): 90 + 90,
    }
    assert sum(_ns(st.idle).values()) == 3000 - 711
    assert st.uncorrelated == 9 and st.unmatched == 0
    assert st.calls == 2 and st.fronts == 2 and st.syncs == 3
    assert st.call_wall_s == pytest.approx(3000e-9)
    assert st.dropped_wall_s == pytest.approx(280e-9)   # the first attempt


def test_uncorrelated_events_with_no_marker():
    """No marker before them: the one launch range opened between their
    neighbours' ops takes them, or the innermost span holding all such
    ranges, or with none the innermost span open over both neighbours'
    launches; with no neighbour on a side, "no span" does."""
    ev = [_Ev(CALL, 0, 100, corr=1), _Ev(P + "cluster.sort", 0, 100, corr=2),
          _Ev("k", 10, 20, dev=True)]
    st = spantrace.reduce_spans(ev)
    assert st.unmatched == 1 and _ns(st.busy) == {spantrace.NO_SPAN: 10}
    lost = ev + [_Ev(P + "phase:round2 boundaries", 1, 60, corr=5),
                 _Ev("aten::lt", 2, 3, corr=6), _Ev("aten::where", 50, 51,
                                                     corr=7),
                 _Ev("lt", 5, 10, dev=True, link=6),
                 _Ev("where", 20, 30, dev=True, link=7)]
    st = spantrace.reduce_spans(lost)      # "k": its op's correlation lost
    r2 = FRONT + ("phase:round2 boundaries",)
    assert st.unmatched == 0 and _ns(st.busy) == {r2: 25}
    one = ev + [_Ev(P + "launch:radix_sort", 5, 8, corr=3)]
    st = spantrace.reduce_spans(one)
    assert st.unmatched == 0 and _ns(st.busy) == {
        FRONT + ("launch:radix_sort",): 10}
    two = one + [_Ev(P + "launch:merge_ranks", 8, 9, corr=4)]
    st = spantrace.reduce_spans(two)
    assert st.unmatched == 0 and _ns(st.busy) == {FRONT: 10}
    assert spantrace.reduce_spans([_Ev("k", 0, 1, dev=True)]) is None


def test_the_device_reduction_is_unmoved_and_carries_the_spans():
    """``install`` leaves ``reduce_events``' DeviceTrace as it was (the
    existing readers read the same numbers) and adds ``.spans``."""
    ev = _events()
    plain = devtrace.reduce_events(ev)
    spantrace.install()
    spantrace.install()                                 # idempotent
    hooked = devtrace.reduce_events(ev)
    assert hooked == plain and dataclasses.asdict(hooked) == \
        dataclasses.asdict(plain)
    assert hooked.spans == spantrace.reduce_spans(ev)
    assert plain.window_s == pytest.approx(3000e-9)
    assert plain.busy_s == pytest.approx(711e-9)
    assert plain.device_events == 18


def test_a_span_reduction_that_raises_fails_the_traced_run(monkeypatch):
    """The wrapper reports nothing quietly: an error of the span
    reduction leaves ``reduce_events`` (and so the traced run) failed,
    not every span metric silently unread."""
    spantrace.install()

    def broken(events):
        raise RuntimeError("broken reduction")

    monkeypatch.setattr(spantrace, "reduce_spans", broken)
    with pytest.raises(RuntimeError, match="broken reduction"):
        devtrace.reduce_events(_events())


def test_the_readers_on_a_synthetic_run():
    ev = _events()
    bench = Bench(ROOT)
    spantrace.install()
    run = _run(trace=devtrace.reduce_events(ev))
    read = {m: bench.reader(m).read(run) for m in (
        "round1_busy_ms.sort", "round2_idle_ms.sort", "round3_busy_ms.sort",
        "round3_idle_ms.sort", "front_door_busy_ms.sort",
        "front_door_idle_ms.sort", "host_syncs.sort",
        "retry_waste_pct.sort")}
    assert read["round1_busy_ms.sort"] == pytest.approx(240e-6 / 2)
    assert read["round2_idle_ms.sort"] == pytest.approx(50e-6 / 2)
    assert read["round3_busy_ms.sort"] == pytest.approx(255e-6 / 2)
    assert read["round3_idle_ms.sort"] == pytest.approx(595e-6 / 2)
    assert read["front_door_busy_ms.sort"] == pytest.approx(10e-6 / 2)
    assert read["front_door_idle_ms.sort"] == pytest.approx(590e-6 / 2)
    assert read["host_syncs.sort"] == 1.5
    assert read["retry_waste_pct.sort"] == pytest.approx(100 * 280 / 3000)
    # a program without spans, or no trace: nothing to read, no error
    bare = [e for e in ev if not e.nm.startswith(P)]
    none = _run(trace=devtrace.reduce_events(bare))
    assert all(bench.reader(m).read(none) is None for m in read)
    assert all(bench.reader(m).read(_run()) is None for m in read)
