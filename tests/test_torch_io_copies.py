"""The port's copies of JAX-package host modules against their sources:
the CLI parser and settings, the PLY / .splat / transforms.json readers,
the .splat writer, the quota bin-size heuristic,
the g++-built PLY expand-writer, the capture helpers of bench.py, the sweep
checkpoint, and the native mesher (meshing_native.py and the g++-built
mesher.cpp).  A drifted copy would be a silent fault, so each is pinned
here."""

import inspect
import os
import types

import numpy as np
import pytest
import torch

import bench
import jax.numpy as jnp
from gs2pc import meshing_native as jax_native
from gs2pc.io import ply as jax_ply
from gs2pc.io import splat as jax_splat
from gs2pc.io import transforms_json as jax_tj
from gs2pc.ops import binning as jax_binning
from gs2pc.parallel.sweep import SweepAccumulators as JaxAccumulators
from gs2pc.utils import checkpoint as jax_checkpoint
from gs2pc.utils import config as jax_config
from gs2pc_torch import meshing_native
from gs2pc_torch.io import ply, splat, transforms_json
from gs2pc_torch.io.ply import PointCloud, save_point_cloud_ply
from gs2pc_torch.ops import binning
from gs2pc_torch.sweep import SweepAccumulators
from gs2pc_torch.utils import capture, checkpoint, config
from tests.fixture_scene import write_capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = ["--input_path", "scene.ply", "--transform_path", "t.json"]
ARGV = [
    BASE,
    BASE + ["--num_points", "1234", "--seed", "9", "--quiet", "--exact_num_points"],
    BASE + ["--surface_distance_std", "1.5", "--visibility_threshold", "0.1",
            "--bounding_box_min", "-1", "-2", "-3", "--bounding_box_max", "1", "2", "3"],
    BASE + ["--colour_quality", "original", "--mask_path", "m", "--camera_skip_rate", "2"],
    BASE + ["--no_compact_pairs", "--no_surface_compact", "--max_pairs_per_tile", "512"],
    # Sharded sweeps.
    BASE + ["--num_devices", "4", "--shard_axis", "gauss"],
    BASE + ["--num_devices", "0", "--shard_axis", "both"],
    # TPU-only flags (the port warns about them).
    BASE + ["--pallas", "off", "--pair_budget", "100", "--tile_slots", "8",
            "--tile_slots_small", "2", "--big_window_cap", "7", "--dispatch_cameras", "3",
            "--sampler_device", "host"],
    # Flags the port once refused (all run now).
    BASE + ["--renderer_type", "python"],
    BASE + ["--generate_mesh", "--poisson_depth", "8", "--clean_pointcloud"],
    BASE + ["--save_sweep", "s.npz", "--load_sweep", "l.npz", "--sh_colour_eval",
            "--auto_capacity", "--profile_dir", "p"],
    ["--input_path", "s.splat", "--no_render_colours", "--no_calculate_normals",
     "--min_opacity", "0.2", "--cull_gaussian_sizes", "0.1", "--max_sh_degree", "0"],
]
INVALID = [
    BASE + ["--min_opacity", "2"],
    ["--input_path", "x.ply"],  # colours without poses
    BASE + ["--renderer_type", "dense", "--surface_distance_std", "1"],
    BASE + ["--colour_quality", "huge"],
]


@pytest.mark.parametrize("argv", ARGV, ids=range(len(ARGV)))
def test_parser_and_settings_match_jax(argv):
    want = jax_config.parse_args(argv)
    got = config.parse_args(argv)
    assert vars(got) == vars(want)
    assert config.settings_from_args(got) == jax_config.settings_from_args(want)


@pytest.mark.parametrize("argv", INVALID, ids=range(len(INVALID)))
def test_parser_refuses_like_jax(argv):
    with pytest.raises(AttributeError) as want:
        jax_config.parse_args(argv)
    with pytest.raises(AttributeError) as got:
        config.parse_args(argv)
    assert str(got.value) == str(want.value)


def test_config_file_matches_jax(tmp_path):
    cfg = tmp_path / "run.cfg"
    cfg.write_text("num_points = 777\nquiet: true\npallas = off\n# comment\nshard_axis=gauss\n")
    argv = BASE + ["--config", str(cfg), "--seed", "3"]
    assert vars(config.parse_args(argv)) == vars(jax_config.parse_args(argv))


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    scene, _, _, paths = write_capture(str(root), n_cams=3, width=64, height=48)
    splat_path = str(root / "scene.splat")
    jax_splat.save_splat(splat_path, *(scene[k] for k in
                                       ("xyz", "log_scales", "rots", "colours", "opacities")))
    return paths, splat_path


def test_readers_match_jax(fixture_files):
    paths, splat_path = fixture_files
    want, got = jax_ply.read_ply(paths["ply"]), ply.read_ply(paths["ply"])
    assert list(got) == list(want)
    for name in want:
        assert got[name].properties == want[name].properties
        np.testing.assert_array_equal(got[name].data, want[name].data)
    for a, b in zip(splat.load_splat_gaussians(splat_path),
                    jax_splat.load_splat_gaussians(splat_path)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert (transforms_json.load_transform_json_data(paths["transforms"], skip_rate=1)
            == jax_tj.load_transform_json_data(paths["transforms"], skip_rate=1))


def test_splat_writer_matches_jax_bytes(fixture_files, tmp_path):
    """save_splat on the fixture's scene and on out-of-range colours,
    opacities and unnormalised rotations: the JAX writer's bytes."""
    _, splat_path = fixture_files
    arrays = splat.load_splat_gaussians(splat_path)[:5]
    r = np.random.default_rng(8)
    q = r.normal(size=(64, 4)).astype(np.float32) * 3.0
    wild = (r.normal(size=(64, 3)), r.uniform(-6, 1, (64, 3)), q,
            r.uniform(-0.5, 1.5, (64, 3)), r.uniform(-0.5, 1.5, 64))
    for i, a in enumerate((arrays, wild)):
        ours, theirs = tmp_path / f"ours{i}.splat", tmp_path / f"theirs{i}.splat"
        splat.save_splat(str(ours), *a)
        jax_splat.save_splat(str(theirs), *a)
        assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name", ["save_splat", "calculate_bin_sizes"])
def test_copied_functions_are_the_jax_source(name):
    """save_splat and calculate_bin_sizes are the JAX package's, line for line."""
    ours, theirs = {"save_splat": (splat, jax_splat),
                    "calculate_bin_sizes": (binning, jax_binning)}[name]
    assert inspect.getsource(getattr(ours, name)) == inspect.getsource(getattr(theirs, name))


def test_ascii_ply_reader_matches_jax(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                    "property uchar red\nend_header\n0.5 1\n-2 200\n3.25 7\n")
    want, got = jax_ply.read_ply(str(path)), ply.read_ply(str(path))
    np.testing.assert_array_equal(got["vertex"].data, want["vertex"].data)


@pytest.mark.parametrize("with_normals", [False, True])
def test_native_writer_matches_jax_bytes(tmp_path, with_normals):
    """The port's g++-built expand-writer and the JAX package's writer
    produce the same bytes."""
    r = np.random.default_rng(5)
    counts = r.integers(0, 7, 40).astype(np.int64)
    cloud = PointCloud(
        points=r.normal(size=(int(counts.sum()), 3)).astype(np.float32),
        counts=counts,
        cols_u8=r.integers(0, 256, (40, 3)).astype(np.uint8),
        gauss_normals=r.normal(size=(40, 3)).astype(np.float32) if with_normals else None,
    )
    ours, theirs = tmp_path / "ours.ply", tmp_path / "theirs.ply"
    assert save_point_cloud_ply(cloud, str(ours), chunk_size=17) == "native_expand"
    gid = cloud.gauss_ids()
    jax_ply.save_point_cloud_ply(
        types.SimpleNamespace(points=cloud.points, colours=cloud.cols_u8[gid],
                              normals=cloud.normals),
        str(theirs), quiet=True,
    )
    assert ours.read_bytes() == theirs.read_bytes()


def test_capture_helpers_match_bench(tmp_path, monkeypatch):
    monkeypatch.delenv("GS2PC_BENCH_SCENE", raising=False)
    a, b = capture.make_scene_arrays(2000), bench.make_scene_arrays(2000, kind="capture")
    pairs = [(a, b), (capture.make_scene_arrays(2000, seed=3, kind="ball"),
                      bench.make_scene_arrays(2000, seed=3, kind="ball")),
             (capture.make_ball_scene_arrays(500), bench.make_ball_scene_arrays(500))]
    monkeypatch.setenv("GS2PC_BENCH_SCENE", "ball")
    pairs.append((capture.make_scene_arrays(700, seed=1), bench.make_scene_arrays(700, seed=1)))
    with pytest.raises(ValueError, match="unknown scene kind"):
        capture.make_scene_arrays(10, kind="file:scene.ply")
    monkeypatch.delenv("GS2PC_BENCH_SCENE")
    for ours, theirs in pairs:
        for name in capture.SceneArrays._fields:
            got, want = getattr(ours, name), getattr(theirs, name)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert capture.make_poses(5, 64, 48) == bench.make_poses(5, 64, 48)
    np.testing.assert_array_equal(capture.vignette_mask(64, 48), bench.vignette_mask(64, 48))
    transforms, intr = capture.make_poses(2, 64, 48)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = capture.write_capture(str(tmp_path / "a"), a, transforms, intr, with_masks=True)
    theirs = bench.write_capture(str(tmp_path / "b"), b, transforms, intr, with_masks=True)
    for x, y in zip(ours[:2], theirs[:2]):
        assert open(x, "rb").read() == open(y, "rb").read()
    for name in transforms:
        assert ((tmp_path / "a" / "masks" / f"{name}.png").read_bytes()
                == (tmp_path / "b" / "masks" / f"{name}.png").read_bytes())


def test_checkpoint_copy_writes_jax_files(tmp_path):
    """Both packages' save_accumulators write the same arrays under the
    same keys with the same dtypes (version, count, fingerprint, planes)."""
    r = np.random.default_rng(7)
    n = 64
    planes = dict(max_contribution=r.uniform(size=n), colours=r.uniform(size=(n, 3)),
                  total_contribution=r.uniform(size=n), min_surface_distance=r.uniform(size=n))
    planes = {k: v.astype(np.float32) for k, v in planes.items()}
    xyz = r.normal(size=(n, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    checkpoint.save_accumulators(ours, SweepAccumulators(
        **{k: torch.tensor(v) for k, v in planes.items()}), n, scene_xyz=torch.tensor(xyz))
    jax_checkpoint.save_accumulators(theirs, JaxAccumulators(
        **{k: jnp.asarray(v) for k, v in planes.items()}), n, scene_xyz=jnp.asarray(xyz))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _surface_points(n=3000, seed=8):
    """Points on a sphere and a plane, the kind of surface cloud the mesher gets."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n // 2, 3))
    sphere = 0.6 * d / np.linalg.norm(d, axis=1, keepdims=True)
    plane = np.c_[r.uniform(-1, 1, n - n // 2), np.full(n - n // 2, -0.8),
                  r.uniform(-1, 1, n - n // 2)]
    pts = np.concatenate([sphere, plane]) + r.normal(scale=0.005, size=(n, 3))
    return pts.astype(np.float32), r.integers(0, 256, (n, 3)).astype(np.float32)


def test_meshing_native_copy_matches_jax(tmp_path):
    """Each step of the port's meshing_native gives the JAX module's arrays,
    and the whole pipeline writes the same mesh PLY bytes."""
    pts, cols = _surface_points()
    grid, origin, voxel = meshing_native.density_grid(pts, resolution=48)
    jgrid, jorigin, jvoxel = jax_native.density_grid(pts, resolution=48)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(origin, jorigin)
    assert voxel == jvoxel
    iso = float(np.quantile(grid[grid > 0], 0.6))
    verts, faces, _ = meshing_native.marching_tetrahedra(grid, iso, origin, voxel)
    smooth = meshing_native.laplacian_smooth(verts, faces, iterations=3)
    np.testing.assert_array_equal(smooth, jax_native.laplacian_smooth(verts, faces, iterations=3))
    for a, b in zip(meshing_native.mesh_vertex_attributes(smooth, pts, cols, grid, origin, voxel),
                    jax_native.mesh_vertex_attributes(smooth, pts, cols, grid, origin, voxel)):
        np.testing.assert_array_equal(a, b)
    ours, theirs = tmp_path / "ours.ply", tmp_path / "theirs.ply"
    got = meshing_native.generate_mesh_native(pts, cols, None, str(ours), depth=6,
                                              laplacian_iters=2)
    want = jax_native.generate_mesh_native(pts, cols, None, str(theirs), depth=6,
                                           laplacian_iters=2)
    np.testing.assert_array_equal(got.verts, want[0])
    np.testing.assert_array_equal(got.faces, want[1])
    assert got.mesher == "native" and got.points == len(pts) and len(got.faces) > 100
    assert ours.read_bytes() == theirs.read_bytes()


def test_mesher_cpp_is_the_jax_source():
    """csrc/mesher.cpp is gs2pc/native/mesher.cpp below its own header
    comment, byte for byte (its output is held to the JAX build's in
    tests/test_torch_meshing.py)."""
    def body(path):
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read()
        return text[text.index("#include"):]

    assert body("gs2pc_torch/csrc/mesher.cpp") == body("gs2pc/native/mesher.cpp")
