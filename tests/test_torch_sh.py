"""View-dependent SH colours (--sh_colour_eval): gs2pc_torch.ops.sh against
gs2pc.ops.sh, the loader's SH columns, and camera sweeps that colour each
camera from the SH (tile and dense renderer on one device, the depth-slab
sweep on [cpu] * 2) against the JAX package's on the same inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc import pipeline as jax_pipeline
from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.io.colmap import load_transform_data as jax_load_transforms
from gs2pc.io.gaussians_io import load_gaussians as jax_load_gaussians
from gs2pc.io.masks import load_image_masks as jax_load_masks
from gs2pc.io.ply import load_ply_gaussians as jax_load_ply_gaussians
from gs2pc.ops import sh as jax_sh
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.parallel import gauss_shard as jax_gs
from gs2pc.parallel.sweep import render_sweep as jax_render_sweep
from gs2pc.utils.config import GaussPointCloudSettings as JaxSettings
from gs2pc.utils.config import RenderConfig as JaxRenderConfig
from gs2pc_torch import pipeline
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.io.colmap import load_transform_data
from gs2pc_torch.io.gaussians_io import load_gaussians, load_ply_gaussians
from gs2pc_torch.io.masks import load_image_masks
from gs2pc_torch.ops import sh
from gs2pc_torch.parallel import gauss_shard
from gs2pc_torch.sweep import SH, render_sweep
from gs2pc_torch.utils.config import GaussPointCloudSettings, RenderConfig
from tests.fixture_scene import write_capture
from tests.test_torch_shard import _assert_close, _cfgs, _gauss_setup

torch.set_num_threads(1)

# test_torch_pipeline.py's bounds for the sweep on one device.
RTOL_ACC = 3e-5
TOL_CONTRIB = 1e-6
TOL_COLOUR = 1e-5
SH_DEGREE = 3


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    r = np.random.default_rng(deg)
    k = (deg + 1) ** 2
    coeffs = r.normal(size=(64, 3, k)).astype(np.float32)
    dirs = r.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jax_sh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = sh.eval_sh(deg, torch.tensor(coeffs), torch.tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(jax_sh.eval_sh_rgb(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = sh.eval_sh_rgb(deg, torch.tensor(coeffs), torch.tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    dc = coeffs[:, :, 0]
    np.testing.assert_array_equal(sh.sh_dc_to_rgb(torch.tensor(dc)).numpy(),
                                  np.asarray(jax_sh.sh_dc_to_rgb(jnp.asarray(dc))))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=4, width=96, height=72)
    return paths


def test_loader_shs_match_jax(capture):
    """The f_rest_* columns land in shs (P, 3, 16) as JAX's loader puts them,
    and are uploaded only when asked for."""
    want = jax_load_ply_gaussians(capture["ply"], max_sh_degree=3)
    got = load_ply_gaussians(capture["ply"], max_sh_degree=3)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[5].shape == (got[0].shape[0], 3, 16)
    g = load_gaussians(capture["ply"], with_shs=True, device="cpu")
    np.testing.assert_array_equal(g.shs.numpy(), want[5])
    assert load_gaussians(capture["ply"], device="cpu").shs is None
    with pytest.raises(ValueError, match="Expected 0 f_rest_"):
        load_ply_gaussians(capture["ply"], max_sh_degree=0)


def _sh_coeffs(n, seed):
    """Random degree-3 SH whose view dependence moves colours by ~0.1."""
    r = np.random.default_rng(seed)
    c = r.normal(scale=0.15, size=(n, 3, 16)).astype(np.float32)
    c[:, :, 0] = r.normal(scale=0.8, size=(n, 3))
    return c


@pytest.mark.parametrize("renderer", ["tile", "dense"])
def test_sh_sweep_matches_jax(renderer):
    """One device: every camera blends its own SH colours."""
    arrays, jcams, tscene, tcams, wp, hp = _gauss_setup()
    jcfg, cfg = _cfgs(wp, hp, run_chunk=64)
    coeffs = _sh_coeffs(tscene.means.shape[0], 4)
    jacc = jax_render_sweep(arrays, jcams, jcfg, renderer=renderer, shs=jnp.asarray(coeffs),
                            sh_degree=SH_DEGREE)
    tacc = render_sweep(tscene, tcams, cfg, renderer=renderer,
                        sh=SH(torch.tensor(coeffs), SH_DEGREE))
    np.testing.assert_allclose(tacc.max_contribution.numpy(), np.asarray(jacc.max_contribution),
                               rtol=RTOL_ACC, atol=TOL_CONTRIB)
    np.testing.assert_allclose(tacc.total_contribution.numpy(),
                               np.asarray(jacc.total_contribution), rtol=RTOL_ACC,
                               atol=3 * TOL_CONTRIB)
    np.testing.assert_allclose(tacc.colours.numpy(), np.asarray(jacc.colours), atol=TOL_COLOUR)
    # The SH moved the colours away from the stored ones.
    plain = render_sweep(tscene, tcams, cfg, renderer=renderer)
    assert float((plain.colours - tacc.colours).abs().max()) > 0.05


def test_sh_depth_slab_sweep_matches_jax():
    """The depth-slab sweep on [cpu] * 2 evaluates SH per slab, against the
    JAX one on a 2-device mesh, at test_torch_shard.py's bounds."""
    arrays, jcams, tscene, tcams, wp, hp = _gauss_setup()
    jcfg, cfg = _cfgs(wp, hp)
    coeffs = _sh_coeffs(tscene.means.shape[0], 5)
    jacc = jax_gs.render_sweep_gauss_sharded(arrays, jcams, jcfg, jax_gs.make_gauss_mesh(2),
                                             shs=jnp.asarray(coeffs), sh_degree=SH_DEGREE)
    tacc = gauss_shard.render_sweep_gauss_sharded(tscene, tcams, cfg, [torch.device("cpu")] * 2,
                                                  sh=SH(torch.tensor(coeffs), SH_DEGREE))
    _assert_close(jacc, tacc)
    np.testing.assert_array_equal(tacc.n_dropped.numpy(), np.asarray(jacc.n_dropped))


def test_pipeline_sh_sweep_matches_jax(capture):
    """run_render_sweep with sh_colour_eval on the fixture capture (degree-3
    SH, masks, surface pass, compact tables) against JAX's."""
    render = dict(pair_budget=1 << 16, max_pairs_per_tile=256, run_chunk=64)
    common = dict(num_points=20_000, colour_resolution=None, quiet=True,
                  surface_distance_std=1.0, sh_colour_eval=True)
    jset = JaxSettings(**common, render=JaxRenderConfig(**render))
    tset = GaussPointCloudSettings(**common, render=RenderConfig(**render))
    transforms, intr = jax_load_transforms(capture["transforms"])
    jg = jax_load_gaussians(capture["ply"], compact_colours=True)
    jcams, wp, hp = jax_build_camera_batch(transforms, intr,
                                           masks=jax_load_masks(capture["masks"]))
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, pair_budget=render["pair_budget"],
                         run_cap=256, run_chunk=64, compact=True, surface_compact=True)
    jacc = jax_pipeline.run_render_sweep(jg, jcams, jcfg, jset, num_devices=1)

    t_transforms, t_intr = load_transform_data(capture["transforms"])
    tcams = build_camera_batch(t_transforms, t_intr, masks=load_image_masks(capture["masks"]),
                               device="cpu")
    tg = load_gaussians(capture["ply"], compact_colours=True, with_shs=True, device="cpu")
    tacc = pipeline.run_render_sweep(tg, tcams, tset)
    np.testing.assert_allclose(tacc.max_contribution.numpy(), np.asarray(jacc.max_contribution),
                               rtol=RTOL_ACC, atol=TOL_CONTRIB)
    np.testing.assert_allclose(tacc.total_contribution.numpy(),
                               np.asarray(jacc.total_contribution), rtol=RTOL_ACC,
                               atol=TOL_CONTRIB)
    np.testing.assert_allclose(tacc.colours.numpy(), np.asarray(jacc.colours), atol=TOL_COLOUR)
    np.testing.assert_array_equal(tacc.n_dropped.numpy(), np.asarray(jacc.n_dropped))
    plain = pipeline.run_render_sweep(tg, tcams, tset._replace(sh_colour_eval=False))
    assert not torch.equal(plain.colours, tacc.colours)
