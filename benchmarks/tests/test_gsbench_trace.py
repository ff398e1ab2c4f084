"""The trace arithmetic on hand-made event lists, and the frozen kernel
counts against the chip smoke test's."""

import importlib.util
import os
import types

import pytest

import gsbench_tiny as tiny
from gsbench import roofline, trace
from gsbench.harness import RunRecord, metric_reader
from gsbench.trace import Interval, Range, Trace

MS = 1_000_000  # ns


def _iv(name, stream, a, b):
    return Interval(name, stream, a * MS, b * MS)


# Two streams: a sweep kernel on 7, an upload on a side stream 13 that
# overlaps it, and a fetch after the sweep.
EVENTS = [
    _iv("project_pack_kernel", 7, 10, 20),
    _iv("Memcpy HtoD (Pinned -> Device)", 13, 15, 30),
    _iv("count_pairs_kernel", 7, 40, 45),
    _iv("write_pairs_cull_kernel", 7, 45, 50),
    _iv("Memcpy DtoH (Device -> Pinned)", 13, 80, 90),
]
RANGES = [
    Range("bench_window", 0, 100 * MS),
    Range("bench_conversion", 0, 100 * MS),
    Range("load_gaussians", 0, 35 * MS),
    Range("render_sweep", 35 * MS, 60 * MS),
    Range("ply_write", 70 * MS, 100 * MS),
]


def test_union_counts_overlaps_once_where_the_sum_counts_them_twice():
    assert trace.summed_seconds(EVENTS) == pytest.approx(0.045)
    assert trace.union_seconds(EVENTS, 0, 100 * MS) == pytest.approx(0.040)
    assert trace.union_seconds(EVENTS, 12 * MS, 42 * MS) == pytest.approx(0.020)


def test_busy_share_inside_the_sweep_ranges():
    busy, wall = trace.busy_within(EVENTS, [RANGES[3]])
    assert (busy, wall) == (pytest.approx(0.010), pytest.approx(0.025))


def test_idle_gaps_are_named_by_the_host_range_around_them():
    gaps = trace.idle_gaps(EVENTS, RANGES, 0, 100 * MS, skip=("bench_window",))
    assert [g[0] for g in gaps] == ["bench_conversion", "load_gaussians", "render_sweep",
                                    "ply_write"]
    assert [g[1] for g in gaps] == pytest.approx([0.030, 0.010, 0.010, 0.010])
    outside = trace.idle_gaps(EVENTS, RANGES[2:], 0, 100 * MS)
    assert outside[0] == ["between conversions", pytest.approx(0.030)]


def test_top_ops_sum_by_name():
    ops = trace.top_ops(EVENTS + [_iv("project_pack_kernel", 7, 52, 54)], 0, 100 * MS)
    assert ops[0] == ["Memcpy HtoD (Pinned -> Device)", pytest.approx(0.015)]
    assert dict(ops)["project_pack_kernel"] == pytest.approx(0.012)


def _record(**kw):
    conv = dict(wall_s=0.1, phases={"load_gaussians": 0.035, "render_sweep": 0.025,
                                    "point_sampling": 0.008, "ply_write": 0.03},
                sweep_diag=[1000.0, 0.0, 200.0, 10.0])
    base = dict(setup_s=5.0, window_s=0.1, conversions=[conv], peak_bytes=2 * 10**9,
                n_gaussians=1000, renders=4, trace=Trace(EVENTS, RANGES),
                window_ns=(0, 100 * MS))
    base.update(kw)
    return RunRecord(**base)


def test_metric_readers_on_a_hand_made_run():
    r = _record()
    assert metric_reader("conversion_s")(r) == pytest.approx(0.1)
    assert metric_reader("peak_device_gb")(r) == pytest.approx(2.0)
    assert metric_reader("load_s")(r) == pytest.approx(0.035)
    assert metric_reader("sample_s")(r) == pytest.approx(0.008)
    assert metric_reader("sweep_busy_pct")(r) == pytest.approx(40.0)
    assert metric_reader("device_idle_pct")(r) == pytest.approx(60.0)
    k2 = (33 * 1000 * 4 + 12 * 1200) / roofline.HBM_BYTES_PER_S / 0.010 * 100
    assert metric_reader("k2_roofline_pct")(r) == pytest.approx(k2)
    k6 = ((154 * 1000 + 144) * 4) / roofline.HBM_BYTES_PER_S / 0.010 * 100
    assert metric_reader("k6_roofline_pct")(r) == pytest.approx(k6)


def test_readers_return_nothing_without_a_trace_or_a_kernel():
    r = _record(trace=None, window_ns=None)
    for name in ("sweep_busy_pct", "device_idle_pct", "k2_roofline_pct", "k6_roofline_pct"):
        assert metric_reader(name)(r) is None
    bare = _record(trace=Trace([_iv("other_kernel", 7, 1, 2)], RANGES))
    assert metric_reader("k2_roofline_pct")(bare) is None
    assert metric_reader("k6_roofline_pct")(bare) is None


def _chip_smoke():
    path = os.path.join(tiny.ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_copy_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_frozen_counts_match_the_chip_smoke_test():
    """PR 13's camera 0: 3M Gaussians, 12.4M pairs, the compact table."""
    cs = _chip_smoke()
    n, pairs = 3_000_000, 12_400_000
    prep = types.SimpleNamespace(xy=types.SimpleNamespace(shape=(n, 2)))
    ms, by = cs.k2_bound(prep, pairs)
    assert roofline.k2_bound(n, 1, pairs) == (pytest.approx(ms / 1e3), by)
    ms, by = cs.k6_bound(n, 8)
    assert roofline.k6_bound(n, 1) == (pytest.approx(ms / 1e3), by)
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_FLOPS_PER_S) == (
        cs.HBM_BYTES_PER_S, cs.FP32_FLOPS_PER_S)
