"""The readers of the program's parse spans and of K1's work counters, on
hand-made runs, and the frozen K1 counts against the chip smoke test's."""

import importlib.util
import os
import types

import pytest
import torch

import gsbench_tiny as tiny
from gsbench import roofline
from gsbench.harness import RunRecord, metric_reader
from gsbench.trace import Interval, Range, Trace

MS = 1_000_000  # ns
SPANS = {"parse_read_s": "ply_read", "parse_columns_s": "ply_columns",
         "parse_sh_s": "ply_sh_rest", "upload_host_s": "plane_upload"}
K1_EVENTS = [Interval("blend_tiles_kernel(BlendParams)", 7, 10 * MS, 14 * MS),
             Interval("blend_tiles_kernel(BlendParams)", 7, 20 * MS, 26 * MS),
             Interval("project_pack_kernel", 7, 5 * MS, 6 * MS)]
RANGES = [Range("bench_window", 0, 100 * MS)]


def _conv(phases, diag):
    return dict(wall_s=0.1, phases=phases, sweep_diag=diag)


def _record(convs, **kw):
    base = dict(setup_s=5.0, window_s=0.2, conversions=convs, peak_bytes=10**9,
                n_gaussians=1000, renders=4, trace=Trace(K1_EVENTS, RANGES),
                window_ns=(0, 100 * MS))
    base.update(kw)
    return RunRecord(**base)


def _module(name):
    path = os.path.join(tiny.BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gsbench_metric_test_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parse_span_readers_take_a_conversions_mean():
    phases = [{"scene_parse": 2.0, "ply_read": 0.25, "ply_columns": 0.5, "ply_sh_rest": 1.2,
               "plane_upload": 0.1},
              {"scene_parse": 2.4, "ply_read": 0.35, "ply_columns": 0.7, "ply_sh_rest": 1.3,
               "plane_upload": 0.3}]
    run = _record([_conv(p, [1.0] * 7) for p in phases])
    for metric, span in SPANS.items():
        assert metric_reader(metric)(run) == pytest.approx(
            (phases[0][span] + phases[1][span]) / 2), metric


def test_readers_return_nothing_on_a_program_without_the_spans_or_counters():
    """The parent's run: scene_parse alone and four truncation counters."""
    run = _record([_conv({"scene_parse": 2.0, "load_gaussians": 2.1}, [1e6, 0.0, 0.0, 0.0])])
    for metric in (*SPANS, "k1_roofline_pct"):
        assert metric_reader(metric)(run) is None, metric
    assert metric_reader("k1_roofline_pct")(_record([_conv({}, None)])) is None


def test_k1_roofline_reads_the_work_counters_over_k1s_device_time():
    convs = [_conv({}, [9e6, 0.0, 0.0, 0.0, 4e6, 0.0, 2e6]),
             _conv({}, [9e6, 0.0, 0.0, 0.0, 6e6, 1e6, 2e6])]
    run = _record(convs)
    ops = 256 * (30 * 10e6 + 3 * 1e6)
    n_bytes = 4 * 10e6 + 28 * 4e6 + 12 * 1000 * 4 * 2
    bound = max(ops / roofline.FP32_FLOPS_PER_S, n_bytes / roofline.HBM_BYTES_PER_S)
    assert ops / roofline.FP32_FLOPS_PER_S > n_bytes / roofline.HBM_BYTES_PER_S
    assert metric_reader("k1_roofline_pct")(run) == pytest.approx(100 * bound / 0.010)
    bare = _record(convs, trace=Trace(K1_EVENTS[2:], RANGES))
    assert metric_reader("k1_roofline_pct")(bare) is None
    assert metric_reader("k1_roofline_pct")(_record(convs, trace=None, window_ns=None)) is None


def _chip_smoke():
    path = os.path.join(tiny.ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_k1_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("with_surface", [False, True])
def test_frozen_k1_counts_match_the_chip_smoke_test(with_surface):
    """Four tiles of one call: the reader's bound from the call's counters
    equals chip_smoke.k1_bound's, operations binding both."""
    cs, k1 = _chip_smoke(), _module("k1_roofline_pct")
    assert (k1.K1_BLEND_FLOPS, k1.K1_SURF_FLOPS, k1.TPX) == (
        cs.K1_BLEND_FLOPS, cs.K1_SURF_FLOPS, cs.TPX)
    counts = torch.tensor([300, 50, 0, 1000])
    chunks = torch.tensor([2, 1, 0, 8], dtype=torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    n = 2000
    args = (torch.zeros(n, 8), torch.arange(int(counts.sum())) % n, starts, counts, None)
    kw = dict(run_chunk=128, with_surface=with_surface, surface_compact=False,
              width_pad=32, height_pad=32)
    ms, by = cs.k1_bound(args, kw, types.SimpleNamespace(chunks=chunks))
    streamed = float(torch.minimum(chunks * 128, counts).sum())
    surface = float(counts.sum()) if with_surface else 0.0
    assert k1.k1_bound(streamed, surface, 32 * 32, n, 1) == (pytest.approx(ms / 1e3), by)
    assert by == "operations"
