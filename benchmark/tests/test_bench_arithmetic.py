"""The harness's arithmetic: the tail, the device trace's busy and idle
time, and the frozen roofline work."""
import types

import pytest

import devtrace
import roofline
import run


def test_p95_nearest_rank():
    assert run.p95(list(range(1, 101))) == 95
    assert run.p95([5.0]) == 5.0
    assert run.p95(list(range(200, 0, -1))) == 190
    assert run.p95([1, 2, 3, 4, 100]) == 100


def trace(device, host=(), window=(0.0, 10.0)):
    return devtrace.Trace(device=list(device), host=list(host),
                          window=window)


def test_union_and_busy():
    assert devtrace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert devtrace.union([(0, 2), (2, 4)]) == [(0, 4)]
    assert devtrace.union([(-1, 2), (9, 12)], 0, 10) == [(0, 2), (9, 10)]
    t = trace([("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0),
               ("d", 9.5, 11.0)])
    assert devtrace.busy_s(t) == pytest.approx(3.0 + 1.0 + 0.5)
    assert devtrace.gaps(t) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]


def test_idle_by_host_names_the_innermost_open_event():
    t = trace([("k", 1.0, 2.0), ("k", 5.0, 6.0)],
              host=[("outer", 0.0, 4.5), ("inner", 2.5, 3.5),
                    ("sync", 6.5, 9.0)])
    got = dict(devtrace.idle_by_host(t))
    # gaps: [0, 1] mid 0.5 -> outer; [2, 5] mid 3.5 -> inner;
    # [6, 10] mid 8 -> sync
    assert got == pytest.approx({"outer": 1.0, "inner": 3.0, "sync": 4.0})


def test_top_ops_and_metric_readers():
    t = trace([("k1", 0.0, 1.0), ("k2", 1.0, 1.5), ("k1", 2.0, 3.0)])
    assert devtrace.top_ops(t) == [["k1", 2.0], ["k2", 0.5]]
    r = types.SimpleNamespace(trace=t, records=[{}, {}])
    assert run.metric_reader("device_idle_pct").read(r) == \
        pytest.approx(75.0)
    assert run.metric_reader("device_ops_per_step").read(r) == 1.5


def test_roofline_work():
    assert roofline.thomas_work(16384, 30, "float64") == \
        (5 * 491520 * 8, 8 * 491520)
    # PERF.md's Thomas bound at [16384, 30] f64: 0.00587 ms
    b, o = roofline.thomas_work(16384, 30, "float64")
    assert roofline.bound_s(b, o, "float64") * 1e3 == \
        pytest.approx(0.00587, rel=1e-3)
    assert roofline.gmres_arnoldi_work(1, 6000, 30, 0, "float64") == \
        ((3 * 6000 + 31) * 8, 7 * 6000)
    # getrf + getrs of one 1 x 1 level is one division and one solve
    assert roofline.btl_ops(1, 1, 1) == 1
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0


def test_launch_share_needs_every_launch():
    t = trace([("thomas_kernel<double>", 0.0, 2e-3),
               ("thomas_kernel<double>", 3e-3, 5e-3)])
    w = (3.35e9, 0, roofline.PEAK_OPS_S)       # 1 ms at 3.35 TB/s
    assert roofline.launch_share(t, ("thomas_kernel",), [w, w],
                                 "float64") == pytest.approx(50.0)
    assert roofline.launch_share(t, ("thomas_kernel",), [w],
                                 "float64") is None
