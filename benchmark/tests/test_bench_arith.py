"""The yardstick's arithmetic on synthetic trace events and shapes: the
sparse pass's least time, a kernel's share of its roofline, the whole
step's share of the peak and the idle share."""

import pytest

import devtrace
import peaks
import readers
from harness import Record


def _record(device, required_s=0.0, shapes=None, window=(0.0, 1.0)):
    r = Record(cell=None)
    r.trace = devtrace.Trace(window[0], window[1], device, [("bench.grid", 0.0, 1.0)])
    r.required_s = required_s
    r.shapes = shapes or {"nnz": 1000, "rows": 100, "features": 50, "members": 4}
    return r


def test_pass_least_time_counts_inputs_once():
    nnz, n, d = 167_772_160, 1 << 22, 1 << 20
    assert peaks.pass_bytes(nnz, d, n) == 12 * nnz + 4 * (n + d)
    assert peaks.pass_least_s(nnz, d, n) == pytest.approx((12 * nnz + 4 * (n + d)) / 3.35e12)
    # bytes bound it: 2 flops a nonzero and member are far below the f32 peak
    assert peaks.pass_least_s(nnz, d, n, 4) > peaks.pass_flops(nnz, 4) / 67e12
    assert peaks.evaluation_least_s(nnz, n, d, 4) == pytest.approx(
        2 * peaks.pass_least_s(nnz, n, d, 4))


def test_union_counts_overlap_once():
    assert devtrace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert devtrace.union_s([]) == 0


def test_roofline_share_matches_launches_and_helpers():
    # names as the profiler gives them on the card
    k2 = "void (anonymous namespace)::grid_bilinear_pass_kernel<4, 2>(photon::Pass)"
    red = "void photon::reduce_shared(int const*, photon::Pass)"
    k1 = "void (anonymous namespace)::bilinear_pass_kernel<4, 1>(photon::Pass)"
    device = [(k2, 0.0, 0.010), (red, 0.010, 0.012), ("void elementwise", 0.02, 0.03),
              (k2, 0.04, 0.052), (k1, 0.06, 0.07)]
    shapes = {"nnz": 10**8, "rows": 10**6, "features": 10**6, "members": 4}
    r = _record(device, shapes=shapes)
    least = peaks.pass_least_s(10**8, 10**6, 10**6, 4)
    assert readers.roofline(r, "grid_bilinear_pass_kernel", 4) == pytest.approx(
        100 * 2 * least / 0.024)
    assert readers.roofline(r, "bilinear_pass_kernel") == pytest.approx(
        100 * peaks.pass_least_s(10**8, 10**6, 10**6) / 0.010)
    assert readers.roofline(r, "absent_kernel") is None
    assert devtrace.short_name(k2) == "grid_bilinear_pass_kernel<4, 2>"
    assert devtrace.short_name(red) == "photon::reduce_shared"


def test_idle_share_and_mfu():
    device = [("a", 0.0, 0.25), ("b", 0.2, 0.5)]
    r = _record(device, required_s=0.1)
    assert readers.idle_share(r) == pytest.approx(50.0)
    assert readers.mfu(r) == pytest.approx(10.0)
    assert readers.idle_share(_record([])) is None
    assert readers.mfu(_record(device, required_s=0.0)) is None


def test_breakdown_names_ops_and_gaps():
    device = [("void k<1>(int)", 0.1, 0.2), ("void k<1>(int)", 0.6, 0.7)]
    host = [("bench.grid", 0.0, 1.0), ("aten::item", 0.25, 0.55), ("aten::mul", 0.75, 0.95)]
    tr = devtrace.Trace(0.0, 1.0, device, host)
    assert tr.top_ops(10) == [["k<1>", pytest.approx(0.2)]]
    gaps = dict((k, v) for k, v in tr.idle_gaps(10))
    assert gaps["bench.grid/aten::item"] == pytest.approx(0.4)
    assert gaps["bench.grid/aten::mul"] == pytest.approx(0.3)
    assert sum(gaps.values()) == pytest.approx(0.8)
    # past the longest gaps only the span names a gap
    monkey = devtrace.LABELLED
    try:
        devtrace.LABELLED = 1
        short = dict((k, v) for k, v in tr.idle_gaps(10))
    finally:
        devtrace.LABELLED = monkey
    assert short == {"bench.grid/aten::item": pytest.approx(0.4),
                     "bench.grid/short gaps": pytest.approx(0.4)}


def test_layer_readings_pass_through():
    r = Record(cell=None)
    r.layer.update(schedule_build_s=12.5, host_fetches=301.0)
    assert readers.layer(r, "schedule_build_s") == 12.5
    assert readers.layer(r, "missing") is None
