"""gs2pc_torch's dense oracle against the JAX package's: blend_chunk,
render_dense in every mode, the port's tile renderer against the port's
oracle (tests/test_render.py's tile-vs-dense bounds), the dense camera
sweep, and the conversion with --renderer_type dense."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc import pipeline as jax_pipeline
from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.ops import blend as jax_blend
from gs2pc.ops.dense_render import render_dense as jax_render_dense
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.parallel.sweep import render_sweep as jax_render_sweep
from gs2pc.utils.config import GaussPointCloudSettings as JaxSettings
from gs2pc_torch import pipeline
from gs2pc_torch.camera import CameraBatch
from gs2pc_torch.ops import blend as B
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.dense_render import render_dense
from gs2pc_torch.parallel import launch
from gs2pc_torch.sweep import RenderArrays, init_accumulators, render_sweep, update_accumulators
from gs2pc_torch.utils.config import GaussPointCloudSettings
from tests.conftest import make_synthetic_scene
from tests.fixture_scene import write_capture
from tests.test_render import _scene_arrays, look_at_camera

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_pool_outlives_the_file():
    """launch.run keeps its ranks for the next run: close them with the file."""
    yield
    launch.shutdown()


# Oracle vs oracle: the same operations, except that the port sums the
# weighted colour / depth over a chunk with one matrix product and JAX
# elementwise (a few ulps); depth-scale values (~4) get 1e-5.
TOL_IMAGE = 1e-6
TOL_CONTRIB = 1e-6
TOL_DEPTH = 1e-5
TOL_SURF = 1e-5
BEST_SHARE = 0.99
# Tile renderer vs oracle (tests/test_render.py:172-189).
TOL_TILE_IMAGE = 2e-4
TOL_TILE_DEPTH = 2e-3
TOL_TILE_CONTRIB = 2e-4
TOL_TILE_BEST = 5e-3


def _t(x):
    return torch.tensor(np.asarray(x))


def _camera(width=64, height=64, focal=70.0, angle=0.4):
    c2w, intr = look_at_camera(angle=angle, width=width, height=height, focal=focal)
    jb, wp, hp = jax_build_camera_batch({"cam0": c2w.tolist()}, {"cam0": intr})
    tb = CameraBatch.from_jax_fields(jb, wp, hp, device="cpu")
    return jb.at(0), tb.at(0), wp, hp


def _chunk_inputs(seed, n_px=64, n_g=48):
    r = np.random.default_rng(seed)
    f = np.float32
    px = r.uniform(0, 16, (n_px, 2)).astype(f)
    xy = r.uniform(-2, 18, (n_g, 2)).astype(f)
    a, c = r.uniform(0.05, 0.6, n_g), r.uniform(0.05, 0.6, n_g)
    b = r.uniform(-0.5, 0.5, n_g) * np.sqrt(a * c)
    conic = np.stack([a, b, c], axis=1).astype(f)
    opacity = r.uniform(0.2, 1.0, n_g).astype(f)
    colour = r.uniform(0, 1, (n_g, 3)).astype(f)
    depth = np.sort(r.uniform(1.0, 6.0, n_g)).astype(f)
    alive = r.uniform(size=n_g) > 0.1
    pair_mask = r.uniform(size=(n_px, n_g)) > 0.2
    t0 = r.uniform(0.0, 1.0, n_px).astype(f)
    t0[:8] = 2e-4  # pixels that stop on their first ok pair
    done0 = r.uniform(size=n_px) < 0.1
    return px, xy, conic, opacity, colour, depth, alive, pair_mask, t0, done0


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_blend_chunk_matches_jax(early_stop, with_mask):
    px, xy, conic, op, col, depth, alive, pmask, t0, done0 = _chunk_inputs(3)
    jc = jax_blend.init_carry((px.shape[0],), jnp.asarray(done0), jnp.asarray(t0))
    tc = B.init_carry((px.shape[0],), _t(done0), _t(t0))
    # Two chunks in a row: the second starts from the first's carry.
    for lo, hi in ((0, 24), (24, 48)):
        args = (px, xy[lo:hi], conic[lo:hi], op[lo:hi], col[lo:hi], depth[lo:hi], alive[lo:hi])
        pm = pmask[:, lo:hi] if with_mask else None
        jc, jw = jax_blend.blend_chunk(
            jc, *(jnp.asarray(a) for a in args),
            pair_mask=None if pm is None else jnp.asarray(pm), early_stop=early_stop,
        )
        tc, tw = B.blend_chunk(tc, *(_t(a) for a in args),
                               pair_mask=None if pm is None else _t(pm), early_stop=early_stop)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL_IMAGE, rtol=0)
        for name in ("transmittance", "colour", "exp_invdepth"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       atol=TOL_IMAGE, rtol=0)
        np.testing.assert_allclose(tc.exp_depth.numpy(), np.asarray(jc.exp_depth),
                                   atol=TOL_DEPTH, rtol=0)
        np.testing.assert_array_equal(tc.done.numpy(), np.asarray(jc.done))
    assert early_stop == bool((tc.done.numpy() & ~done0).any())


def _vignette(wp, hp):
    ys, xs = np.mgrid[0:hp, 0:wp]
    m = ((xs - wp / 2) / (0.5 * wp)) ** 2 + ((ys - hp / 2) / (0.5 * hp)) ** 2 <= 1.0
    return m.astype(np.uint8).reshape(-1)


DENSE_CASES = {
    # name: (rect_cull, mask, surface pass, block_range, pixel_chunk)
    "plain": (False, False, True, None, 1 << 16),
    "rect_cull": (True, False, True, None, 1 << 16),
    "mask_blocks": (True, True, True, None, 1024),
    "no_surface": (False, True, False, None, 1024),
    "band": (True, False, False, (1, 2), 1024),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_render_dense_matches_jax(case):
    rect_cull, masked, surface, block_range, pixel_chunk = DENSE_CASES[case]
    jcam, tcam, wp, hp = _camera()
    arrays = _scene_arrays(200, seed=4)
    mask = _vignette(wp, hp) if masked else None
    kw = dict(chunk=64, pixel_chunk=pixel_chunk, rect_cull=rect_cull,
              calc_surface_distance=surface, block_range=block_range)
    oj = jax_render_dense(*arrays, jcam, wp, hp,
                          mask=None if mask is None else jnp.asarray(mask), **kw)
    ot = render_dense(*(_t(a) for a in arrays), tcam, wp, hp,
                      mask=None if mask is None else _t(mask), **kw)
    assert ot.n_dropped is None and oj.n_dropped is None
    np.testing.assert_allclose(ot.image.numpy(), np.asarray(oj.image), atol=TOL_IMAGE, rtol=0)
    np.testing.assert_allclose(ot.invdepth.numpy(), np.asarray(oj.invdepth), atol=TOL_IMAGE,
                               rtol=0)
    np.testing.assert_allclose(ot.depth.numpy(), np.asarray(oj.depth), atol=TOL_DEPTH, rtol=0)
    np.testing.assert_allclose(ot.contrib.numpy(), np.asarray(oj.contrib), atol=TOL_CONTRIB,
                               rtol=0)
    np.testing.assert_array_equal(ot.radii.numpy(), np.asarray(oj.radii))
    sj, st = np.asarray(oj.surf_dist), ot.surf_dist.numpy()
    np.testing.assert_array_equal(sj < 1e30, st < 1e30)
    np.testing.assert_allclose(np.minimum(st, 1e6), np.minimum(sj, 1e6), atol=TOL_SURF)
    if surface:
        assert (st < 1e30).sum() > 20
    hit = np.asarray(oj.contrib) > 0
    assert hit.sum() > 20
    same = np.abs(ot.best_colour.numpy() - np.asarray(oj.best_colour)).max(axis=1) <= 1e-5
    assert same[hit].mean() >= BEST_SHARE
    if block_range is not None:
        assert ot.image.shape == (2 * pixel_chunk // wp, wp, 3)


@pytest.mark.parametrize("angle", [0.0, 1.1])
def test_tile_renderer_matches_dense_oracle(angle):
    """The port's tile renderer (K1's twin) against the port's oracle with
    rect culling, as tests/test_render.py holds the JAX tile renderer."""
    _, tcam, wp, hp = _camera(width=128, height=128, focal=150.0, angle=angle)
    arrays = [_t(a) for a in _scene_arrays(200)]
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=256, run_chunk=64)
    out_t = R.render_tile_camera(*arrays, tcam, cfg)
    out_d = render_dense(*arrays, tcam, wp, hp, chunk=64, rect_cull=True)
    np.testing.assert_allclose(out_t.image.numpy(), out_d.image.numpy(), atol=TOL_TILE_IMAGE)
    np.testing.assert_allclose(out_t.depth.numpy(), out_d.depth.numpy(), atol=TOL_TILE_DEPTH)
    np.testing.assert_allclose(out_t.contrib.numpy(), out_d.contrib.numpy(),
                               atol=TOL_TILE_CONTRIB)
    seen = out_t.contrib.numpy() > 1e-4
    assert seen.sum() > 20
    np.testing.assert_allclose(out_t.best_colour.numpy()[seen],
                               out_d.best_colour.numpy()[seen], atol=TOL_TILE_BEST)


def _sweep_scene(masked):
    scene = make_synthetic_scene(300, seed=8, spread=1.0, scale_lo=-3.5, scale_hi=-1.5)
    transforms, intr = {}, {}
    for i in range(3):
        c2w, intrinsic = look_at_camera(angle=0.9 * i, width=48, height=40, focal=60.0)
        transforms[f"c{i}"], intr[f"c{i}"] = c2w.tolist(), intrinsic
    masks = None
    if masked:
        masks = {name: (np.arange(48 * 40).reshape(40, 48) % 7 != 0).astype(np.uint8)
                 for name in transforms}
    jcams, wp, hp = jax_build_camera_batch(transforms, intr, masks=masks)
    arrays = (scene.xyz, scene.covariance_factors(), scene.opacities * 0.9, scene.colours,
              jnp.ones(300, bool))
    tscene = RenderArrays(*(_t(a) for a in arrays))
    return arrays, jcams, tscene, CameraBatch.from_jax_fields(jcams, wp, hp, device="cpu"), wp, hp


@pytest.mark.parametrize("masked,surface", [(False, True), (True, False)])
def test_dense_sweep_matches_jax(masked, surface):
    arrays, jcams, tscene, tcams, wp, hp = _sweep_scene(masked)
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, pair_budget=1 << 14, run_chunk=64)
    jacc = jax_render_sweep(arrays, jcams, jcfg, renderer="dense",
                            calc_surface_distance=surface)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_chunk=64)
    tacc = render_sweep(tscene, tcams, cfg, calc_surface_distance=surface, renderer="dense")
    np.testing.assert_allclose(tacc.max_contribution.numpy(), np.asarray(jacc.max_contribution),
                               atol=TOL_CONTRIB)
    np.testing.assert_allclose(tacc.total_contribution.numpy(),
                               np.asarray(jacc.total_contribution), atol=3 * TOL_CONTRIB)
    same = np.abs(tacc.colours.numpy() - np.asarray(jacc.colours)).max(axis=1) <= 1e-5
    assert same.mean() >= BEST_SHARE
    sj, st = np.asarray(jacc.min_surface_distance), tacc.min_surface_distance.numpy()
    np.testing.assert_array_equal(sj < 1e30, st < 1e30)
    np.testing.assert_allclose(np.minimum(st, 1e6), np.minimum(sj, 1e6), atol=TOL_SURF)
    # The oracle has no counters: the sweep's stay at zero.
    assert torch.equal(tacc.n_dropped, torch.zeros(4, dtype=torch.float64))


def test_counters_without_a_renderer_that_counts():
    """update_accumulators keeps the counters when a camera brings none (the
    dense oracle), and adds them when it does."""
    acc = init_accumulators(3, device="cpu")
    out = B.RenderOutput(
        image=torch.zeros(1), depth=torch.zeros(1), invdepth=torch.zeros(1),
        radii=torch.zeros(3), contrib=torch.tensor([0.5, 0.0, 0.2]),
        best_colour=torch.ones((3, 3)), surf_dist=torch.full((3,), 2.0),
    )
    acc = update_accumulators(acc, out)
    assert torch.equal(acc.n_dropped, torch.zeros(4, dtype=torch.float64))
    counted = out._replace(n_dropped=torch.tensor([5.0, 0.0, 1.0, 0.0], dtype=torch.float64))
    acc = update_accumulators(acc, counted)
    assert acc.n_dropped.tolist() == [5.0, 0.0, 1.0, 0.0]
    assert acc.max_contribution.tolist() == [0.5, 0.0, 0.20000000298023224]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=3, width=64, height=48)
    return paths


DENSE_SETTINGS = dict(num_points=8000, colour_resolution=None, quiet=True,
                      renderer_type="dense")


def test_dense_conversion_matches_jax(capture, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
        jpc, _ = jax_pipeline.convert_3dgs_to_pc(
            capture["ply"], capture["transforms"], capture["masks"],
            JaxSettings(**DENSE_SETTINGS), num_devices=1,
        )
    res = pipeline.convert_3dgs_to_pc(
        capture["ply"], capture["transforms"], capture["masks"],
        GaussPointCloudSettings(**DENSE_SETTINGS), device="cpu",
    )
    np.testing.assert_array_equal(res.cloud.counts, np.asarray(jpc._counts))
    assert res.cloud.total == jpc.total == int(res.cloud.counts.sum())
    assert res.sweep_diag == [0.0, 0.0, 0.0, 0.0]
    same = np.abs(res.cloud.cols_u8.astype(int) - np.asarray(jpc._cols_u8).astype(int)) <= 1
    assert same.all(axis=1).mean() >= BEST_SHARE


def test_dense_conversion_blends_jax_colours(capture, tmp_path):
    """With --renderer_type dense the colour plane is uploaded in float32, as
    JAX's loader does: only the tile renderer's compact tables quantise it
    to 8 bits (gs2pc/pipeline.py:851-855).  Both conversions' loaded planes
    and dense sweeps' colours, captured on the way, agree within 1e-6 (an
    8-bit plane is up to 2e-3 off)."""
    got = {}

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            got[key] = out = real(*a, **kw)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
        mp.setattr(jax_pipeline, "load_gaussians", spy(jax_pipeline, "load_gaussians", "jax_g"))
        mp.setattr(jax_pipeline, "run_render_sweep",
                   spy(jax_pipeline, "run_render_sweep", "jax_acc"))
        mp.setattr(pipeline, "load_gaussians", spy(pipeline, "load_gaussians", "g"))
        mp.setattr(pipeline, "run_render_sweep", spy(pipeline, "run_render_sweep", "acc"))
        jax_pipeline.convert_3dgs_to_pc(
            capture["ply"], capture["transforms"], capture["masks"],
            JaxSettings(**DENSE_SETTINGS), num_devices=1,
        )
        pipeline.convert_3dgs_to_pc(
            capture["ply"], capture["transforms"], capture["masks"],
            GaussPointCloudSettings(**DENSE_SETTINGS), device="cpu",
        )
    np.testing.assert_allclose(got["g"].colours.numpy(), np.asarray(got["jax_g"][0].colours),
                               rtol=0, atol=1e-6)
    tc, jc = got["acc"].colours.numpy(), np.asarray(got["jax_acc"].colours)
    same = np.abs(tc - jc).max(axis=1) <= 1e-6
    assert same.mean() >= BEST_SHARE


@pytest.mark.parametrize("axis", ["gauss", "both"])
def test_dense_refused_with_gaussian_axis(capture, axis):
    settings = GaussPointCloudSettings(**DENSE_SETTINGS, shard_axis=axis)
    with pytest.raises(ValueError, match=f"--shard_axis {axis} requires the tile renderer"):
        pipeline.convert_3dgs_to_pc(capture["ply"], capture["transforms"], capture["masks"],
                                    settings, device="cpu", num_devices=2)


def test_dense_camera_split_matches_one_device(capture):
    """The camera split takes the dense renderer: on [cpu] * 2 it gives the
    single sweep's point cloud."""
    settings = GaussPointCloudSettings(**DENSE_SETTINGS)
    one = pipeline.convert_3dgs_to_pc(capture["ply"], capture["transforms"], capture["masks"],
                                      settings, device="cpu")
    two = pipeline.convert_3dgs_to_pc(capture["ply"], capture["transforms"], capture["masks"],
                                      settings, device="cpu", num_devices=2)
    np.testing.assert_array_equal(one.cloud.counts, two.cloud.counts)
    np.testing.assert_array_equal(one.cloud.cols_u8, two.cloud.cols_u8)
