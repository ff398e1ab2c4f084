"""BASELINE.json's configs 1-4 (tests/test_baseline_configs.py:37-139) on
the fixture capture, JAX against the port on the CPU, each parsed from the
same command line by each package's own CLI parser and run through its
conversion function: equal quotas, u8 colours and point counts, and every
point inside its Gaussian's Mahalanobis ball (the random numbers differ).
Config 5 is held in tests/test_torch_meshing.py.  Also the counterpart of
tests/test_semantic_colours.py: red and green walls come back red and
green through the port's conversion."""

import json

import numpy as np
import pytest
import torch

from gs2pc import pipeline as jax_pipeline
from gs2pc.utils import config as jax_config
from gs2pc_torch import pipeline
from gs2pc_torch.io.gaussians_io import load_gaussians
from gs2pc_torch.io.splat import save_splat
from gs2pc_torch.utils import config
from tests.fixture_scene import write_capture
from tests.test_render import look_at_camera

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("capture"))
    _, _, _, paths = write_capture(root, seed=5, n_cams=3, width=64, height=48)
    return paths


def _configs(paths):
    """tests/test_baseline_configs.py's command lines, budgets cut by 2-4x;
    config 2 renders one camera of the three (--camera_skip_rate 2): its
    dense oracle at 360x270 costs ~13 s a camera on each side."""
    return {
        1: ["--input_path", paths["ply"], "--no_render_colours", "--num_points", "8000"],
        2: ["--input_path", paths["ply"], "--transform_path", paths["transforms"],
            "--renderer_type", "python", "--colour_quality", "low", "--camera_skip_rate", "2",
            "--num_points", "4000"],
        3: ["--input_path", paths["ply"], "--transform_path", paths["colmap"],
            "--colour_quality", "original", "--num_points", "8000", "--tile_slots", "32",
            "--max_pairs_per_tile", "512"],
        4: ["--input_path", paths["ply"], "--transform_path", paths["transforms"],
            "--mask_path", paths["masks"], "--exact_num_points", "--surface_distance_std", "2.0",
            "--colour_quality", "original", "--num_points", "6000", "--tile_slots", "32",
            "--max_pairs_per_tile", "512"],
    }


def _convert_both(argv, tmp_path):
    argv = argv + ["--quiet"]
    jargs = jax_config.parse_args(argv)
    with pytest.MonkeyPatch.context() as mp:  # no stale JAX budget-probe cache
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
        jpc, _ = jax_pipeline.convert_3dgs_to_pc(
            jargs.input_path, jargs.transform_path, jargs.mask_path,
            jax_config.settings_from_args(jargs), num_devices=1)
    args = config.parse_args(argv)
    settings = config.settings_from_args(args)
    res = pipeline.convert_3dgs_to_pc(args.input_path, args.transform_path, args.mask_path,
                                      settings, device="cpu", num_devices=args.num_devices)
    return jpc, res.cloud, settings


@pytest.mark.parametrize("cfg", [1, 2, 3, 4])
def test_baseline_config_matches_jax(capture, tmp_path, cfg):
    jpc, cloud, settings = _convert_both(_configs(capture)[cfg], tmp_path)
    np.testing.assert_array_equal(np.asarray(jpc._counts), cloud.counts)
    np.testing.assert_array_equal(np.asarray(jpc._cols_u8), cloud.cols_u8)
    assert cloud.total == jpc.total == int(cloud.counts.sum()) > 0
    assert np.isfinite(cloud.points).all()
    if cfg == 4:  # --exact_num_points: the budget, exactly
        assert cloud.total == 6000
    g = load_gaussians(capture["ply"], device="cpu").validate_covariances()
    gid = torch.tensor(cloud.gauss_ids())
    d = torch.tensor(cloud.points).double() - g.xyz[gid].double()
    z = torch.einsum("nji,nj->ni", g.rotation_matrices()[gid].double(), d)
    z = z / torch.exp(g.log_scales[gid]).double()
    assert float(z.norm(dim=1).max()) <= settings.mahalanobis_distance_std + 1e-4


def test_wall_colours_assigned_correctly(tmp_path):
    """tests/test_semantic_colours.py's red (x < 0) and green (x > 0) walls,
    three cameras, 20k points through the port's conversion."""
    r = np.random.default_rng(3)
    pts, cols = [], []
    for sx, colour in ((-1.0, [1.0, 0.05, 0.05]), (1.0, [0.05, 1.0, 0.05])):
        n = 400
        pts.append(np.stack([np.full(n, sx * 0.8) + r.normal(scale=0.01, size=n),
                             r.uniform(-0.6, 0.6, n), r.uniform(-0.6, 0.6, n)], axis=1))
        cols.append(np.tile(colour, (n, 1)))
    xyz = np.concatenate(pts).astype(np.float32)
    n = len(xyz)
    splat = str(tmp_path / "walls.splat")
    save_splat(splat, xyz, np.full((n, 3), -2.7, np.float32),
               np.tile([[1.0, 0, 0, 0]], (n, 1)).astype(np.float32),
               np.concatenate(cols).astype(np.float32), np.full(n, 0.95, np.float32))
    frames = []
    for i, ang in enumerate([0.0, 0.5, -0.5]):
        c2w, _ = look_at_camera(angle=ang, width=96, height=96, focal=110.0)
        frames.append({"file_path": f"c{i}.png", "transform_matrix": c2w.tolist(),
                       "w": 96, "h": 96, "fl_x": 110.0})
    tpath = str(tmp_path / "transforms.json")
    with open(tpath, "w") as fh:
        json.dump({"frames": frames}, fh)

    settings = config.GaussPointCloudSettings(num_points=20_000, colour_resolution=None,
                                              quiet=True)
    cloud = pipeline.convert_3dgs_to_pc(splat, tpath, None, settings, device="cpu").cloud
    p, c = cloud.points, cloud.cols_u8[cloud.gauss_ids()].astype(int)
    left, right = p[:, 0] < -0.3, p[:, 0] > 0.3
    assert left.sum() > 1000 and right.sum() > 1000
    assert (c[left, 0] > c[left, 1] + 30).mean() > 0.8, "left wall not red"
    assert (c[right, 1] > c[right, 0] + 30).mean() > 0.8, "right wall not green"
    assert c[left, 0].mean() > 180 and c[right, 1].mean() > 180
