"""gs2pc_torch's last three tools against the JAX package on the CPU:
render_preview's PNGs against the JAX tile render, convert_format's bytes
against the JAX writer and tool, pixel_forensics' float64 blend against
the JAX tile image, and the standard-library PNG round trip."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.io.colmap import load_transform_data as jax_load_transforms
from gs2pc.io.gaussians_io import load_gaussians as jax_load_gaussians
from gs2pc.io.splat import save_splat as jax_save_splat
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.ops.rasterize import render_tile_camera as jax_render
from gs2pc_torch.camera import CameraBatch
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.tools import convert_format, diff_map, pixel_forensics, render_preview
from gs2pc_torch.utils.imaging import imread_png, imwrite, to_u8
from tests.conftest import make_synthetic_scene
from tests.fixture_scene import write_capture
from tests.test_render import look_at_camera

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 against f64 through a blend of a few dozen Gaussians.
TOL_FORENSICS = 1e-5


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=2, width=64, height=48)
    return paths


def _jax_previews(paths):
    """The JAX tool's images: render_tile_camera per camera, no surface pass."""
    g = jax_load_gaussians(paths["ply"])
    transforms, intr = jax_load_transforms(paths["transforms"])
    cams, wp, hp = jax_build_camera_batch(transforms, intr)
    arrays = (g.xyz, g.covariance_factors(), g.opacities, g.colours,
              jnp.ones(g.num_gaussians, bool))
    cfg = JaxTileConfig(width_pad=wp, height_pad=hp, big_cap=g.num_gaussians)
    out = {}
    for i, name in enumerate(transforms):
        o = jax_render(*arrays, cams.at(i), cfg, calc_surface_distance=False)
        w, h = int(cams.width[i]), int(cams.height[i])
        out[name] = (np.asarray(o.image)[:h, :w], np.asarray(o.depth)[:h, :w])
    return out


def test_render_preview_matches_jax(capture, tmp_path):
    written = render_preview.main([
        "--input_path", capture["ply"], "--transform_path", capture["transforms"],
        "--out_dir", str(tmp_path), "--colour_quality", "original", "--depth",
        "--device", "cpu",
    ])
    jax_out = _jax_previews(capture)
    assert len(written) == 2 * len(jax_out) == 4
    scene = render_preview.scene_arrays(
        render_preview.load_gaussians(capture["ply"], device="cpu"))
    cams = render_preview.build_camera_batch(
        *render_preview.load_transform_data(capture["transforms"]), device="cpu")
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    for i, (name, (j_img, j_depth)) in enumerate(jax_out.items()):
        img = imread_png(str(tmp_path / f"{name}.png"))
        depth = imread_png(str(tmp_path / f"{name}_depth.png"))
        assert img.shape == j_img.shape and depth.shape == j_depth.shape
        for got, want in ((img, to_u8(j_img)),
                          (depth, to_u8(render_preview.normalised_depth(j_depth)))):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        twin = R.render_tile_camera(*scene, cams.at(i), cfg, calc_surface_distance=False)
        h, w = j_img.shape[:2]
        np.testing.assert_array_equal(img, to_u8(twin.image[:h, :w].numpy()))
        np.testing.assert_array_equal(
            depth, to_u8(render_preview.normalised_depth(twin.depth[:h, :w].numpy())))
        assert img.max() > 0


def _splat(path, n=16, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jax_save_splat(path, r.normal(size=(n, 3)).astype(np.float32),
                   r.uniform(-4, -2, (n, 3)).astype(np.float32), q,
                   r.uniform(0, 1, (n, 3)).astype(np.float32),
                   r.uniform(0.1, 0.9, n).astype(np.float32))


def test_convert_format_bytes_match_jax(capture, tmp_path):
    # .ply -> .splat: JAX save_splat on the JAX loader's arrays.
    ours, theirs = str(tmp_path / "ours.splat"), str(tmp_path / "theirs.splat")
    assert convert_format.main([capture["ply"], ours]) > 0
    g = jax_load_gaussians(capture["ply"])
    jax_save_splat(theirs, *(np.asarray(a) for a in (g.xyz, g.log_scales, g.rots, g.colours,
                                                     g.opacities)))
    assert open(ours, "rb").read() == open(theirs, "rb").read()

    # .splat -> .ply: the JAX tool, run as tests/test_tools.py runs it.
    src = str(tmp_path / "a.splat")
    _splat(src)
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    convert_format.main([src, ours])
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "convert_format.py"), src, theirs],
        capture_output=True, text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-500:]
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_convert_format_round_trip(tmp_path):
    """splat -> ply -> splat keeps tests/test_tools.py's tolerances."""
    src, mid, back = (str(tmp_path / n) for n in ("a.splat", "a.ply", "b.splat"))
    _splat(src)
    convert_format.main([src, mid])
    convert_format.main([mid, back])
    a, b = convert_format.load_host(src), convert_format.load_host(back)
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)  # xyz
    np.testing.assert_allclose(a[4], b[4], atol=2 / 255)  # opacities
    np.testing.assert_allclose(a[1], b[1], atol=1e-4)  # log scales
    with pytest.raises(SystemExit, match="Unsupported destination"):
        convert_format.main([src, str(tmp_path / "x.obj")])


def test_blend_pixel_matches_jax_tile_image():
    n = 256
    scene = make_synthetic_scene(n, seed=21, spread=1.0, scale_lo=-3.4, scale_hi=-1.8)
    c2w, intr = look_at_camera(width=64, height=64, focal=70.0, angle=0.4)
    jcams, wp, hp = jax_build_camera_batch({"c0": c2w.tolist()}, {"c0": intr})
    arrays = (scene.xyz, scene.covariance_factors(), scene.opacities, scene.colours,
              jnp.ones(n, bool))
    cfg = JaxTileConfig(width_pad=wp, height_pad=hp, big_cap=n, run_cap=4096)
    img = np.asarray(jax_render(*arrays, jcams.at(0), cfg, calc_surface_distance=True).image)
    cam = CameraBatch.from_jax_fields(jcams, wp, hp, device="cpu").at(0)
    prep = pixel_forensics.prepare(*(np.asarray(a) for a in arrays[:4]), cam)
    r = np.random.default_rng(4)
    pixels = [(32, 32)] + [tuple(int(v) for v in r.integers(0, 64, 2)) for _ in range(7)]
    blended = 0
    for x, y in pixels:
        rgb, n_bl, log = pixel_forensics.blend_pixel(prep, x, y)
        assert n_bl == len(log)
        blended += n_bl
        np.testing.assert_allclose(rgb, img[y, x], atol=TOL_FORENSICS)
    assert blended > 8


def test_pixel_forensics_main_on_diff_map_images(tmp_path, capsys):
    small = ["--device", "cpu", "--gaussians", "300", "--width", "64", "--height", "64"]
    tile, oracle = str(tmp_path / "tile.npz"), str(tmp_path / "oracle.npz")
    diff_map.main(small + ["--oracle_npz", oracle, "--save_npz", tile])
    recs = pixel_forensics.main(small + ["--tile_npz", tile, "--oracle_npz", oracle,
                                         "--worst", "5"])
    assert len(recs) == 5
    for rec in recs:
        assert rec["side"] in ("TILE wrong", "ORACLE wrong", "both off")
        assert np.isfinite(rec["truth"]).all() and rec["err_tile"] < 0.05
    assert capsys.readouterr().out.count("-> ") == 5


@pytest.mark.parametrize("shape", [(5, 7, 3), (9, 4), (1, 1, 3)])
def test_png_round_trip(tmp_path, shape):
    image = np.random.default_rng(sum(shape)).uniform(-0.2, 1.2, shape)
    path = str(tmp_path / "x.png")
    imwrite(path, image)
    got = imread_png(path)
    assert got.dtype == np.uint8 and got.shape == shape[:2] + shape[2:]
    np.testing.assert_array_equal(got, to_u8(image))
