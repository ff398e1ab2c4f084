"""Host transfers as the JAX package overlaps them: the port's
LazyPointCloud (points stay on the device; the PLY writer pulls them a
chunk at a time) against gs2pc.pipeline.LazyPointCloud, its streamed PLY
bytes against the JAX writer's and the eager writer's, the native chunked
session against the one-shot expand-writer, the loader's planes, each
filled in the array its allocator gave, against
gs2pc.io.ply.load_ply_gaussians', and the one slot prefix a sampling
computes.  On CPU tensors the lazy cloud's chunks are slices of
its points; tests/test_torch_cuda.py runs the pinned, double-buffered
copies on a card."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc.io import ply as jax_ply
from gs2pc.pipeline import LazyPointCloud as JaxLazyPointCloud
from gs2pc_torch import pipeline
from gs2pc_torch.io import gaussians_io
from gs2pc_torch.io.ply import PointCloud, save_point_cloud_ply
from gs2pc_torch.io.splat import save_splat
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import cuda_build, prng
from gs2pc_torch.ops import sampler as S
from gs2pc_torch.utils import capture
from gs2pc_torch.utils.config import GaussPointCloudSettings
from tests.fixture_scene import write_capture
from tests.test_torch_ply_blocks import write_ply

torch.set_num_threads(1)

# Extra rows past the cloud's total in the sampled buffer (K5's output is
# exactly n rows; the JAX sampler's is padded to its slot cap).
PAD_ROWS = 4


def _lazy(seed=0, n_gauss=37, with_normals=True, run=None):
    """(port cloud, JAX cloud, points, colours, normals, counts): counts in
    0..8 with every fifth Gaussian empty, and with ``run`` one Gaussian of
    that many points, so a chunk edge falls inside its run."""
    r = np.random.default_rng(seed)
    counts = r.integers(0, 9, n_gauss).astype(np.int64)
    counts[::5] = 0
    if run is not None:
        counts[3] = run
    total = int(counts.sum())
    pts = r.standard_normal((total, 3)).astype(np.float32)
    cols = r.integers(0, 256, (n_gauss, 3)).astype(np.uint8)
    nrm = r.standard_normal((n_gauss, 3)).astype(np.float32) if with_normals else None
    buf = np.concatenate([pts, np.zeros((PAD_ROWS, 3), np.float32)])
    ours = pipeline.LazyPointCloud(torch.tensor(buf), counts, cols, nrm, total)
    theirs = JaxLazyPointCloud(jnp.asarray(buf.ravel()), counts, cols, nrm, total)
    return ours, theirs, pts, cols, nrm, counts


@pytest.mark.parametrize("with_normals", [True, False])
def test_lazy_cloud_matches_jax(with_normals):
    """points, colours and normals of the port's lazy cloud equal JAX's on
    the same arrays, from a buffer longer than the cloud."""
    ours, theirs, pts, cols, nrm, counts = _lazy(with_normals=with_normals)
    assert ours.total == theirs.total == int(counts.sum())
    np.testing.assert_array_equal(ours.points, np.asarray(theirs.points))
    np.testing.assert_array_equal(ours.points, pts)
    np.testing.assert_array_equal(ours.gauss_ids(), theirs._gauss_ids())
    np.testing.assert_array_equal(ours.cols_u8[ours.gauss_ids()].astype(np.float32),
                                  theirs.colours)
    if with_normals:
        np.testing.assert_array_equal(ours.normals, theirs.normals)
    else:
        assert ours.normals is None and theirs.normals is None


@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_lazy_cloud_streams_jax_chunks(chunk):
    """stream_chunks yields JAX's chunks in order; point_rows yields each
    chunk's first row with slices of the points."""
    ours, theirs, pts, *_ = _lazy(run=12)
    got, want = list(ours.stream_chunks(chunk)), list(theirs.stream_chunks(chunk))
    assert len(got) == len(want) == -(-ours.total // chunk)
    for (p, c, n), (jp, jc, jn) in zip(got, want):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(n, jn)
    rows = list(ours.point_rows(chunk))
    assert [lo for lo, _ in rows] == list(range(0, ours.total, chunk))
    np.testing.assert_array_equal(np.concatenate([p for _, p in rows]), pts)
    with pytest.raises(ValueError):
        next(ours.point_rows(0))


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("with_normals", [True, False])
@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_streamed_ply_matches_jax_and_eager(tmp_path, monkeypatch, chunk, with_normals, route):
    """The lazy cloud's PLY, through the native session or numpy chunk by
    chunk, has the bytes of the JAX package's save_point_cloud_ply on its
    LazyPointCloud and of the port's eager writer.  A chunk edge falls
    inside a 12-point run (chunk 7), and every fifth Gaussian has no point."""
    ours, theirs, pts, cols, nrm, counts = _lazy(seed=1, with_normals=with_normals, run=12)
    if route == "numpy":
        monkeypatch.setattr(cuda_build, "load_plyio", lambda: None)
    lazy, jax_out, eager = (str(tmp_path / f"{n}.ply") for n in ("lazy", "jax", "eager"))
    writer = save_point_cloud_ply(ours, lazy, chunk_size=chunk)
    assert writer == {"native": "native_stream", "numpy": "numpy_stream"}[route]
    jax_ply.save_point_cloud_ply(theirs, jax_out, chunk_size=chunk, quiet=True)
    eager_writer = save_point_cloud_ply(PointCloud(pts, counts, cols, nrm), eager,
                                        chunk_size=chunk)
    assert eager_writer == {"native": "native_expand", "numpy": "numpy"}[route]
    data = open(lazy, "rb").read()
    assert data == open(jax_out, "rb").read() == open(eager, "rb").read()
    assert len(data) > ours.total * (27 if with_normals else 15)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_streamed_empty_cloud(tmp_path, monkeypatch, route):
    """A cloud of no points writes the header alone, as JAX's writer does."""
    if route == "numpy":
        monkeypatch.setattr(cuda_build, "load_plyio", lambda: None)
    counts = np.zeros(5, np.int64)
    cols = np.zeros((5, 3), np.uint8)
    ours = pipeline.LazyPointCloud(torch.zeros((0, 3)), counts, cols, None, 0)
    theirs = JaxLazyPointCloud(jnp.zeros(0, jnp.float32), counts, cols, None, 0)
    assert list(ours.stream_chunks(7)) == []
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    save_point_cloud_ply(ours, a)
    jax_ply.save_point_cloud_ply(theirs, b, quiet=True)
    assert open(a, "rb").read() == open(b, "rb").read() == jax_ply._ply_header(0, False)


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _session(lib, path, pts, counts, cols, nrm, chunk):
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    handle = lib.gs2pc_ply_open(path.encode(), len(pts), int(nrm is not None))
    assert handle is not None
    rcs = []
    for lo in range(0, len(pts), chunk):
        part = np.ascontiguousarray(pts[lo:lo + chunk])
        rcs.append(lib.gs2pc_ply_write_chunk(handle, _ptr(part), lo, lo + len(part),
                                             _ptr(offs), len(counts), _ptr(cols), _ptr(nrm)))
    return rcs, lib.gs2pc_ply_close(handle)


@pytest.mark.parametrize("with_normals", [True, False])
@pytest.mark.parametrize("chunk", [1, 5, 64, 10_000])
def test_native_session_matches_expand_writer(tmp_path, chunk, with_normals):
    """gs2pc_ply_open / write_chunk / close write gs2pc_write_ply_expand's
    bytes, chunk by chunk, from buffers that hold one chunk each."""
    lib = cuda_build.load_plyio()
    assert lib is not None, cuda_build.PLYIO_INFO
    _, _, pts, cols, nrm, counts = _lazy(seed=2, n_gauss=300, with_normals=with_normals, run=40)
    a, b = str(tmp_path / "session.ply"), str(tmp_path / "expand.ply")
    rcs, rc = _session(lib, a, pts, counts, cols, nrm, chunk)
    assert set(rcs) == {0} and rc == 0
    assert lib.gs2pc_write_ply_expand(b.encode(), len(pts), _ptr(pts), _ptr(counts),
                                      len(counts), _ptr(cols), _ptr(nrm), chunk) == 0
    assert open(a, "rb").read() == open(b, "rb").read()


def test_native_session_refuses_rows_out_of_order(tmp_path):
    """A chunk that does not follow the rows written, or a close before all
    rows came, fails the session."""
    lib = cuda_build.load_plyio()
    _, _, pts, cols, _, counts = _lazy(seed=3, with_normals=False)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    args = (_ptr(offs), len(counts), _ptr(cols), None)
    path = str(tmp_path / "x.ply").encode()
    h = lib.gs2pc_ply_open(path, len(pts), 0)
    assert lib.gs2pc_ply_write_chunk(h, _ptr(pts), 0, 10, *args) == 0
    assert lib.gs2pc_ply_write_chunk(h, _ptr(pts[20:]), 20, 30, *args) < 0
    assert lib.gs2pc_ply_close(h) < 0
    h = lib.gs2pc_ply_open(path, len(pts), 0)
    assert lib.gs2pc_ply_write_chunk(h, _ptr(pts), 0, 10, *args) == 0
    assert lib.gs2pc_ply_close(h) < 0


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """An RGB .ply (the capture's layout), a degree-3 SH .ply and a .splat."""
    root = tmp_path_factory.mktemp("scenes")
    a = capture.make_scene_arrays(300, seed=5)
    rgb = str(root / "rgb.ply")
    capture.write_scene_ply(rgb, a)
    splat = str(root / "scene.splat")
    save_splat(splat, a.xyz, a.log_scales, a.rots, a.colours, a.opacities)
    sh_root = root / "sh"
    sh_root.mkdir()
    _, _, _, paths = write_capture(str(sh_root), n_cams=1, width=32, height=24)
    return {"rgb": rgb, "sh": paths["ply"], "splat": splat}


class _Alloc:
    """An ``alloc`` for load_ply_gaussians: NaN-filled float32 planes (so a
    row left unfilled shows), kept by name in the order asked for."""

    def __init__(self):
        self.given = {}

    def __call__(self, name, shape):
        plane = self.given[name] = np.full(shape, np.nan, np.float32)
        return plane


PLANE_NAMES = ("xyz", "log_scales", "rots", "colours", "opacities", "shs")


@pytest.mark.parametrize("kind", ["rgb", "sh"])
def test_plane_hook_matches_jax(scenes, kind):
    """The port's loader returns JAX's planes, each one the very array
    ``alloc`` gave for its name, asked for by JAX's names in the order
    JAX's hook gets them, and equal to what it returns without ``alloc``."""
    alloc = _Alloc()
    got = gaussians_io.load_ply_gaussians(scenes[kind], alloc=alloc)
    hooked = []
    want = jax_ply.load_ply_gaussians(scenes[kind],
                                      plane_hook=lambda name, array: hooked.append(name))
    assert list(alloc.given) == hooked
    assert hooked == (["xyz", "opacities", "colours", "shs", "log_scales", "rots"]
                      if kind == "sh" else ["xyz", "opacities", "colours", "log_scales", "rots"])
    for name, a, b in zip(PLANE_NAMES, got, want):
        if b is None:
            assert a is None and name not in alloc.given, name
            continue
        assert a is alloc.given[name], name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, gaussians_io.load_ply_gaussians(scenes[kind])):
        np.testing.assert_array_equal(a, b)


def _today(path, compact, with_shs):
    """The scene from the parsed arrays: parse everything, then
    Gaussians.from_numpy."""
    if path.endswith(".splat"):
        from gs2pc_torch.io.splat import load_splat_gaussians

        xyz, ls, rots, cols, op, shs = load_splat_gaussians(path)
    else:
        xyz, ls, rots, cols, op, shs = gaussians_io.load_ply_gaussians(path)
    if compact:
        cols = gaussians_io.quantise_colours_u8(cols)
    return Gaussians.from_numpy(xyz, ls, rots, cols, op, shs=shs if with_shs else None,
                                device="cpu")


def assert_same_scene(got: Gaussians, want: Gaussians) -> None:
    for name in ("xyz", "log_scales", "rots", "opacities", "colours", "shs", "keep_mask"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.cpu(), b.cpu()), name
    assert got.normals is None


@pytest.mark.parametrize("case", ["rgb", "rgb_compact", "sh", "sh_with_shs", "sh_compact",
                                  "splat", "splat_compact"])
def test_hooked_load_equals_from_numpy(scenes, case):
    """load_gaussians (planes uploaded as the parser hands them over) gives
    the Gaussians from_numpy gave on the parsed arrays, bit for bit: RGB,
    SH with and without its coefficients, compact colours, .splat."""
    kind = case.split("_")[0]
    compact, with_shs = case.endswith("compact"), case.endswith("with_shs")
    got = gaussians_io.load_gaussians(scenes[kind], compact_colours=compact, with_shs=with_shs,
                                      device="cpu")
    assert_same_scene(got, _today(scenes[kind], compact, with_shs))
    if with_shs:
        assert got.shs.shape[1:] == (3, 16)


def test_plane_upload_skips_shs_and_quantises(tmp_path):
    """A degree-1 SH .ply with no opacity, scale_* or rot* fields, loaded
    without its SH coefficients and with compact colours: every plane comes
    from ``alloc``, no shs plane is asked for, the planes the file has no
    fields for hold the JAX loader's constants (opacity 1, log-scale -8,
    the unit quaternion), and the colours are quantise_colours_u8 of
    JAX's."""
    props = [(p, "float") for p in ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(9)]]
    path = write_ply(tmp_path / "bare.ply", props, 50, seed=6)
    alloc = _Alloc()
    got = gaussians_io.load_ply_gaussians(path, max_sh_degree=1, with_shs=False, alloc=alloc,
                                          compact_colours=True)
    want = jax_ply.load_ply_gaussians(path, max_sh_degree=1)
    assert list(alloc.given) == ["xyz", "opacities", "colours", "log_scales", "rots"]
    assert got[5] is None
    for name, a, b in zip(PLANE_NAMES[:5], got, want):
        assert a is alloc.given[name], name
        expect = gaussians_io.quantise_colours_u8(b) if name == "colours" else b
        assert a.dtype == expect.dtype and a.shape == expect.shape, name
        np.testing.assert_array_equal(a, expect)
    np.testing.assert_array_equal(got[4], np.ones(50, np.float32))
    np.testing.assert_array_equal(got[1], np.full((50, 3), -8.0, np.float32))
    np.testing.assert_array_equal(got[2], np.tile(np.float32([[1, 0, 0, 0]]), (50, 1)))


def _small_scene(n=200, seed=7):
    a = capture.make_scene_arrays(n, seed=seed)
    return Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours * 255.0, a.opacities,
                                device="cpu")


@pytest.mark.parametrize("exact", [False, True])
def test_generate_point_cloud_computes_one_slot_prefix(monkeypatch, exact):
    """One slot_prefix a sampling serves the sampler and the counts: the
    counts are diff(min(prefix, n)) of the quotas' prefix and the points
    those of sample_points computing its own prefix."""
    g = _small_scene()
    settings = GaussPointCloudSettings(num_points=3000, exact_num_points=exact, seed=3,
                                       quiet=True)
    calls = []
    real = S.slot_prefix

    def counting(*args, **kwargs):
        calls.append(args[1:])
        return real(*args, **kwargs)

    monkeypatch.setattr(pipeline, "slot_prefix", counting)
    monkeypatch.setattr(S, "slot_prefix", counting)
    cloud = pipeline.generate_point_cloud(g, settings)
    assert len(calls) == 1
    assert isinstance(cloud, pipeline.LazyPointCloud)
    monkeypatch.setattr(pipeline, "slot_prefix", real)
    monkeypatch.setattr(S, "slot_prefix", real)

    sizes = torch.where(g.keep_mask, g.magnitudes(), 0.0)
    ppg = S.distribute_points(sizes, 3000, mask=g.keep_mask, exact=exact)
    n_cap = 3000 + 4096
    max_points = 3000 if exact else None
    prefix, n = real(ppg, n_cap, max_points)
    want = np.diff(np.minimum(prefix.numpy(), n), prepend=0)
    assert cloud.counts.dtype == np.int64
    np.testing.assert_array_equal(cloud.counts, want)
    assert cloud.total == n == int(cloud.counts.sum())
    ref = S.sample_points(torch.tensor(prng.PRNGKey(3).tolist()), g, ppg, n_cap,
                          settings.mahalanobis_distance_std, max_points).points
    np.testing.assert_array_equal(cloud.points, ref.numpy())
    np.testing.assert_array_equal(cloud.cols_u8,
                                  torch.clamp(g.colours, 0, 255).to(torch.uint8).numpy())


def test_trace_phases_attribute_copies_to_phases(tmp_path):
    """bench_kernels reads a profiler trace's copies by the phase whose
    host call issued them (the innermost), and a phase's host time outside
    PyTorch's ops and CUDA calls."""
    import json

    from gs2pc_torch.tools.bench_kernels import trace_copies, trace_phases

    def ann(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}

    def call(ts, dur, corr):
        return {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": ts, "dur": dur,
                "pid": 1, "tid": 1, "args": {"correlation": corr}}

    def copy(kind, corr, n, dur):
        return {"cat": "gpu_memcpy", "name": kind, "ts": 0, "dur": dur,
                "args": {"correlation": corr, "bytes": n}}

    events = [
        ann("load_gaussians", 0, 100), ann("scene_parse", 0, 50), ann("ply_write", 200, 100),
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 205, "dur": 20, "pid": 1, "tid": 1},
        call(10, 3, 1), call(210, 3, 2), call(400, 3, 3),
        copy("Memcpy HtoD (Pinned -> Device)", 1, 100, 5),
        copy("Memcpy DtoH (Device -> Pinned)", 2, 240, 7),
        copy("Memcpy DtoH (Device -> Pageable)", 3, 12, 2),
        {"cat": "kernel", "name": "k", "ts": 0, "dur": 4, "args": {"correlation": 2}},
    ]
    path = str(tmp_path / "trace.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)
    names = ["load_gaussians", "scene_parse", "ply_write"]
    assert trace_copies(path, names) == [
        ("Memcpy HtoD (Pinned -> Device)", 100, 0.005, "scene_parse"),
        ("Memcpy DtoH (Device -> Pinned)", 240, 0.007, "ply_write"),
        ("Memcpy DtoH (Device -> Pageable)", 12, 0.002, None)]
    got = trace_phases(path, names)
    assert got["scene_parse"]["copies"] == {
        "Memcpy HtoD (Pinned -> Device)": {"count": 1, "bytes": 100, "ms": 0.005}}
    assert got["ply_write"]["kernels_ms"] == pytest.approx(0.004)
    assert got["ply_write"]["host_outside_ops_ms"] == pytest.approx(0.080)
    assert got["scene_parse"]["host_outside_ops_ms"] == pytest.approx(0.047)
    assert got["load_gaussians"]["copies"] == {}
