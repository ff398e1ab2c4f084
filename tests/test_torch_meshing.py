"""Cleaning and meshing (--clean_pointcloud, --generate_mesh): the Morton
codes, the windowed kNN, the outlier mask, apply_knn_filter and the
cleaned point cloud against gs2pc.meshing; the native and numpy marching
tetrahedra and the mesh PLY against gs2pc.meshing_native; and the mesh
branch of the conversion (surface pass on, the surface point quota)
against the JAX pipeline."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc import meshing as jax_meshing
from gs2pc import meshing_native as jax_native
from gs2pc import pipeline as jax_pipeline
from gs2pc.models.gaussians import Gaussians as JaxGaussians
from gs2pc.utils.config import GaussPointCloudSettings as JaxSettings
from gs2pc.utils.config import RenderConfig as JaxRenderConfig
from gs2pc_torch import meshing, meshing_native, pipeline
from gs2pc_torch.io.ply import PointCloud
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops.blend import FLOAT_MAX
from gs2pc_torch.utils.config import GaussPointCloudSettings, RenderConfig
from tests.fixture_scene import write_capture

torch.set_num_threads(1)

# A point whose mean kNN distance lies this close (relative) to the
# threshold may fall on either side: the mean and std are float32 sums in
# another order.
THRESHOLD_RTOL = 1e-6


def _cloud(n=256, seed=0, outliers=6):
    """Points on a few blobs, with repeated points (duplicate Morton codes)
    and far outliers."""
    r = np.random.default_rng(seed)
    centres = r.uniform(-1, 1, (4, 3))
    pts = centres[r.integers(0, 4, n)] + r.normal(scale=0.05, size=(n, 3))
    pts[: n // 8] = pts[n // 8: n // 4]  # repeats
    if outliers:
        pts[-outliers:] = r.uniform(-6, 6, (outliers, 3))
    return pts.astype(np.float32)


def test_morton_codes_match_jax():
    pts = _cloud()
    # A coarse lattice too: many points share a code.
    grid = (np.random.default_rng(1).integers(0, 6, (256, 3)) * 0.2).astype(np.float32)
    for p in (pts, grid):
        want = np.asarray(jax_meshing._morton_codes(jnp.asarray(p))).astype(np.int64)
        got = meshing._morton_codes(torch.tensor(p)).numpy()
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) < len(want)


@pytest.mark.parametrize("k,window", [(20, 32), (10, 8), (3, 2)])
def test_knn_mean_distance_matches_jax(k, window, monkeypatch):
    pts = _cloud(seed=2)
    monkeypatch.setattr(meshing, "KNN_CHUNK_ROWS", 100)  # several row chunks
    want = np.asarray(jax_meshing.knn_mean_distance(jnp.asarray(pts), k=k, window=window))
    got = meshing.knn_mean_distance(torch.tensor(pts), k=k, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _near(values, threshold):
    return np.abs(values - threshold) <= THRESHOLD_RTOL * np.abs(threshold)


@pytest.mark.parametrize("std_ratio", [10.0, 3.0, 0.5])
def test_outlier_mask_matches_jax(std_ratio):
    pts = _cloud(seed=3)
    want = np.asarray(jax_meshing.statistical_outlier_mask(jnp.asarray(pts), std_ratio=std_ratio))
    got = meshing.statistical_outlier_mask(torch.tensor(pts), std_ratio=std_ratio).numpy()
    d = meshing.knn_mean_distance(torch.tensor(pts)).numpy().astype(np.float64)
    near = _near(d, d.mean() + std_ratio * d.std())
    np.testing.assert_array_equal(got[~near], want[~near])
    assert (~got).sum() > 0 or std_ratio == 10.0


def test_apply_knn_filter_matches_jax():
    pts = _cloud(seed=4)
    r = np.random.default_rng(4)
    arrays = (pts, r.uniform(-4, -2, (256, 3)), np.tile([1.0, 0, 0, 0], (256, 1)),
              r.uniform(0, 1, (256, 3)), r.uniform(0, 1, 256))
    d = np.asarray(jax_meshing.knn_mean_distance(jnp.asarray(pts), k=10))
    max_dist = float(np.median(d))
    want = np.asarray(JaxGaussians.create(*arrays).apply_knn_filter(max_dist=max_dist).keep_mask)
    g = Gaussians.from_numpy(*arrays, device="cpu")
    got = g.apply_knn_filter(max_dist=max_dist).keep_mask.numpy()
    near = _near(d, max_dist)
    np.testing.assert_array_equal(got[~near], want[~near])
    assert 0 < got.sum() < got.size


def test_clean_point_cloud_matches_jax():
    """The cleaned cloud keeps JAX's points; its counts are the kept points
    per Gaussian, so the expanded colours and normals follow them."""
    pts = _cloud(seed=5)
    counts = np.full(32, 8, np.int64)
    r = np.random.default_rng(5)
    cloud = PointCloud(points=pts, counts=counts,
                       cols_u8=r.integers(0, 256, (32, 3)).astype(np.uint8),
                       gauss_normals=r.normal(size=(32, 3)).astype(np.float32))
    jp, jc, jn = jax_meshing.clean_point_cloud(cloud.points, cloud.cols_u8[cloud.gauss_ids()],
                                               cloud.normals)
    got = meshing.clean_point_cloud(cloud, device="cpu")
    np.testing.assert_array_equal(got.points, jp)
    np.testing.assert_array_equal(got.cols_u8[got.gauss_ids()], jc)
    np.testing.assert_array_equal(got.normals, jn)
    assert got.counts.sum() == got.total < cloud.total


def _grid():
    """A density grid with a few blobs (tests/test_meshing_native.py's kind)."""
    pts = _cloud(2000, seed=6, outliers=0)
    return jax_native.density_grid(pts, resolution=40)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_marching_tetrahedra_match_jax(route):
    grid, origin, voxel = _grid()
    iso = float(np.quantile(grid[grid > 0], 0.7))
    if route == "native":
        want = jax_native._marching_tetrahedra_native(grid, iso, origin, voxel)
        got = meshing_native._marching_tetrahedra_native(grid, iso, origin, voxel)
        assert want is not None and got is not None  # g++ built both
        verts, faces, mesher = meshing_native.marching_tetrahedra(grid, iso, origin, voxel)
        assert mesher == "native"
        np.testing.assert_array_equal(verts, got[0])
    else:
        want = jax_native._marching_tetrahedra_numpy(grid, iso, origin, voxel)
        got = meshing_native._marching_tetrahedra_numpy(grid, iso, origin, voxel)
    assert len(got[1]) > 100
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_numpy_mesher_runs_without_the_native_one(monkeypatch):
    grid, origin, voxel = _grid()
    iso = float(np.quantile(grid[grid > 0], 0.7))
    monkeypatch.setattr(meshing_native, "_marching_tetrahedra_native", lambda *a: None)
    verts, faces, mesher = meshing_native.marching_tetrahedra(grid, iso, origin, voxel)
    want = jax_native._marching_tetrahedra_numpy(grid, iso, origin, voxel)
    assert mesher == "numpy"
    np.testing.assert_array_equal(faces, want[1])


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=3, width=64, height=48)
    return paths


MESH = dict(num_points=20_000, colour_resolution=None, quiet=True, generate_mesh=True)
RENDER = dict(pair_budget=1 << 16, max_pairs_per_tile=512, run_chunk=64)


@pytest.fixture(scope="module")
def mesh_conversions(capture, tmp_path_factory):
    """Both conversions with --generate_mesh and no --surface_distance_std:
    only the mesh turns the surface pass on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
        jpc, jsurf = jax_pipeline.convert_3dgs_to_pc(
            capture["ply"], capture["transforms"], capture["masks"],
            JaxSettings(**MESH, render=JaxRenderConfig(**RENDER)), num_devices=1)
    res = pipeline.convert_3dgs_to_pc(
        capture["ply"], capture["transforms"], capture["masks"],
        GaussPointCloudSettings(**MESH, render=RenderConfig(**RENDER)), device="cpu")
    return jpc, jsurf, res


def test_generate_mesh_turns_the_surface_pass_on(capture):
    """run_render_sweep measures surface distances for --generate_mesh even
    without --surface_distance_std, as JAX's does."""
    from gs2pc_torch.camera import build_camera_batch
    from gs2pc_torch.io.colmap import load_transform_data
    from gs2pc_torch.io.gaussians_io import load_gaussians

    transforms, intr = load_transform_data(capture["transforms"])
    cams = build_camera_batch(transforms, intr, device="cpu")
    g = load_gaussians(capture["ply"], device="cpu")
    settings = GaussPointCloudSettings(**MESH, render=RenderConfig(**RENDER))
    acc = pipeline.run_render_sweep(g, cams, settings)
    assert int((acc.min_surface_distance < FLOAT_MAX).sum()) > 0
    off = pipeline.run_render_sweep(g, cams, settings._replace(generate_mesh=False))
    assert bool((off.min_surface_distance == FLOAT_MAX).all())


def test_surface_quota_matches_jax(mesh_conversions):
    jpc, jsurf, res = mesh_conversions
    np.testing.assert_array_equal(res.cloud.counts, np.asarray(jpc._counts))
    n_surface, n_mesh = res.surface_quota
    assert n_mesh == min(MESH["num_points"] // 2,
                         n_surface * pipeline.AVG_POINTS_PER_GAUSS_FOR_MESH)
    assert 0 < n_surface < res.cloud.counts.shape[0]
    np.testing.assert_array_equal(res.surface_cloud.counts, np.asarray(jsurf._counts))
    np.testing.assert_array_equal(res.surface_cloud.cols_u8, np.asarray(jsurf._cols_u8))
    assert res.surface_cloud.total == jsurf.total
    # The surface cloud samples with its own seed: other points than the main cloud's.
    assert not np.array_equal(res.surface_cloud.points[:100], res.cloud.points[:100])


def test_mesh_ply_matches_jax_bytes(mesh_conversions, tmp_path):
    """generate_mesh on the JAX conversion's surface points (native route,
    no Open3D) writes JAX's mesh PLY byte for byte."""
    _, jsurf, _ = mesh_conversions
    pts, cols, nrm = jsurf.points, jsurf.colours, jsurf.normals
    want_keep = np.asarray(jax_meshing.statistical_outlier_mask(jnp.asarray(pts), std_ratio=3.0))
    got_keep = meshing.statistical_outlier_mask(torch.tensor(pts), std_ratio=3.0).numpy()
    np.testing.assert_array_equal(got_keep, want_keep)
    ours, theirs = tmp_path / "ours.ply", tmp_path / "theirs.ply"
    jax_meshing.generate_mesh(pts, cols, nrm, str(theirs), depth=6, laplacian_iters=2)
    mesh = meshing.generate_mesh(pts, cols.astype(np.uint8), nrm, str(ours), depth=6,
                                 laplacian_iters=2, device="cpu")
    assert mesh.mesher == "native" and mesh.points == int(want_keep.sum())
    assert len(mesh.faces) > 50 and np.isfinite(mesh.verts).all()
    assert ours.read_bytes() == theirs.read_bytes()
