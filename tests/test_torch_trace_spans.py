"""The port's spans and counters for the benchmark's per-layer metrics:
utils.log.span / trace_range, the scene parse split into ply_read,
ply_columns, ply_sh_rest and plane_upload, the sweep's per-camera ranges,
K1's work counter (RenderOutput.k1_work, SweepAccumulators.k1_work and the
three entries it appends to Conversion.sweep_diag), and the busy time of
tools/bench_kernels.device_profile (the union of the device intervals)."""

import json
import threading

import pytest
import torch

from gs2pc_torch import pipeline
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.io import gaussians_io
from gs2pc_torch.io.colmap import load_transform_data
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.blend_kernel import blend_tiles
from gs2pc_torch.sweep import render_arrays, render_sweep, render_sweep_sharded
from gs2pc_torch.tools.bench_kernels import device_busy_s
from gs2pc_torch.utils import log
from tests.fixture_scene import write_capture

PARSE_SPANS = ("ply_read", "ply_columns", "ply_sh_rest")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    _, _, _, paths = write_capture(str(tmp_path_factory.mktemp("spans")), n_cams=3,
                                   width=64, height=48)
    return paths


@pytest.fixture(scope="module")
def sweep_inputs(capture):
    """The capture's scene and cameras on the CPU, and a tiling with a small
    run chunk, so a tile's early stop shows in its chunks."""
    gaussians = gaussians_io.load_gaussians(capture["ply"], compact_colours=True,
                                            device="cpu")
    transforms, intrinsics = load_transform_data(capture["transforms"], skip_rate=0)
    cams = build_camera_batch(transforms, intrinsics, device="cpu")
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad, run_cap=4096,
                       run_chunk=8, compact=True)
    return render_arrays(gaussians), cams, cfg


@pytest.fixture
def no_sync(monkeypatch):
    """Counts torch.cuda.synchronize calls (and makes them no-ops)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    return calls


def test_span_adds_seconds_from_any_thread_without_a_sync(no_sync):
    log.reset_phases()
    with log.span("main_step"):
        pass
    with log.span("main_step"):
        pass

    def worker():
        for _ in range(50):
            with log.span("worker_step"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert set(log.PHASE_SECONDS) == {"main_step", "worker_step"}
    assert all(v >= 0.0 for v in log.PHASE_SECONDS.values())
    assert no_sync == []


@pytest.mark.parametrize("helper", ["span", "trace_range"])
def test_no_profiler_range_while_no_profiler_records(monkeypatch, helper):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    log.reset_phases()
    with getattr(log, helper)("quiet_step"):
        pass
    assert opened == []
    assert ("quiet_step" in log.PHASE_SECONDS) == (helper == "span")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with getattr(log, helper)("traced_step"):
            pass
    assert opened == ["traced_step"]


def _ranges(prof) -> dict:
    """name -> [(start_ns, end_ns)] of the profile's user annotations."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append((int(e.start_ns()), int(e.end_ns())))
    return out


def test_ply_load_spans_nest_in_scene_parse(capture, no_sync):
    log.reset_phases()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gaussians_io.load_gaussians(capture["ply"], device="cpu")
    ranges = _ranges(prof)
    (parse,) = ranges["scene_parse"]
    for name in PARSE_SPANS:
        assert ranges[name], name
        assert all(parse[0] <= a <= b <= parse[1] for a, b in ranges[name]), name
    # The three split the parse without overlapping.
    spans = sorted(r for name in PARSE_SPANS for r in ranges[name])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    seconds = log.PHASE_SECONDS
    assert 0.0 < sum(seconds[n] for n in PARSE_SPANS) <= seconds["scene_parse"]
    # Off a card each plane is handed over inline: five planes (no SH).
    assert 0.0 < seconds["plane_upload"] <= seconds["scene_parse"]


def _recording_blend(calls):
    def blend(*args, **kwargs):
        res = blend_tiles(*args, **kwargs)
        calls.append((args[3].long(), res.chunks.long(), kwargs["run_chunk"]))
        return res
    return blend


def test_k1_work_counts_the_streamed_pairs(sweep_inputs, monkeypatch):
    scene, cams, cfg = sweep_inputs
    # Large opaque Gaussians, so tiles finish before their run ends.
    scene = scene._replace(opacities=torch.full_like(scene.opacities, 0.99),
                           cov_factors=scene.cov_factors * 3.0)
    calls = []
    monkeypatch.setattr(R, "blend_tiles", _recording_blend(calls))
    acc = render_sweep(scene, cams, cfg, calc_surface_distance=False)
    assert len(calls) == cams.num_cameras
    want = sum(int(torch.minimum(chunks * chunk, counts).sum())
               for counts, chunks, chunk in calls)
    diag = pipeline.report_truncation(acc)
    assert len(diag) == 7
    streamed, surface, pixels = diag[4:]
    assert streamed == want > 0
    assert streamed <= diag[0]
    assert surface == 0.0
    assert pixels == cams.num_cameras * cfg.width_pad * cfg.height_pad
    # The early stop bites: fewer pairs streamed than the capped run.
    assert streamed < diag[0]


@pytest.mark.parametrize("surface_compact", [False, True])
def test_k1_work_counts_the_surface_pass(sweep_inputs, surface_compact):
    scene, cams, cfg = sweep_inputs
    cfg = cfg._replace(surface_compact=surface_compact)
    diag = pipeline.report_truncation(render_sweep(scene, cams, cfg))
    assert diag[5] == (diag[4] if surface_compact else diag[0])


def test_sweep_diag_has_the_work_counters_on_the_tile_sweep_only(sweep_inputs):
    scene, cams, cfg = sweep_inputs
    tile = pipeline.report_truncation(render_sweep(scene, cams, cfg))
    dense = pipeline.report_truncation(render_sweep(scene, cams, cfg, renderer="dense"))
    assert len(tile) == 7 and len(dense) == 4
    assert pipeline.truncation_material(tile) == pipeline.truncation_material(tile[:4])


def test_walked_sweep_counts_k1_work_as_one_device(sweep_inputs):
    scene, cams, cfg = sweep_inputs
    one = render_sweep(scene, cams, cfg)
    two = render_sweep_sharded(scene, cams, cfg, [torch.device("cpu")] * 2)
    assert torch.equal(two.k1_work, one.k1_work)
    assert torch.equal(two.n_dropped, one.n_dropped)


def test_device_busy_is_the_union_of_the_device_intervals(tmp_path):
    """A kernel and an upload on a side stream overlapping by 5 us: the busy
    time counts the overlap once; annotations and host events stay out."""
    events = [
        {"cat": "kernel", "name": "k", "ts": 10, "dur": 10},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 15, "dur": 15},
        {"cat": "gpu_memset", "name": "Memset", "ts": 40, "dur": 5},
        {"cat": "kernel", "name": "inside", "ts": 41, "dur": 2},
        {"cat": "gpu_user_annotation", "name": "render_sweep", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "render_sweep", "ts": 0, "dur": 100},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 50, "dur": 30},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert device_busy_s(str(path)) == pytest.approx(25e-6)
