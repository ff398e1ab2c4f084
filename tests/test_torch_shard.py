"""gs2pc_torch's multi-device sweeps on repeated CPU devices against the JAX
package's on its virtual CPU mesh: the camera data-parallel sweep, the
depth-slab (Gaussian-axis) sweep and the 2-D split, their slab assignment,
a masked case, a run-cap-saturating case, the pipeline on four devices and
the --num_devices rules.  The scenes are tests/test_sharding.py's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.parallel import gauss_shard as jax_gs
from gs2pc.parallel.mesh import make_mesh
from gs2pc.parallel.sweep import render_sweep as jax_render_sweep
from gs2pc.parallel.sweep import render_sweep_sharded as jax_render_sweep_sharded
from gs2pc_torch import pipeline
from gs2pc_torch.camera import CameraBatch
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.parallel import gauss_shard, launch
from gs2pc_torch.sweep import RenderArrays, render_sweep, render_sweep_sharded
from gs2pc_torch.utils.config import GaussPointCloudSettings as Settings
from tests.conftest import make_synthetic_scene
from tests.test_render import look_at_camera

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_pool_outlives_the_file():
    """launch.run keeps its ranks for the next run: close them with the file."""
    yield
    launch.shutdown()


# tests/test_sharding.py's bounds for a sharded sweep against one device:
# f32 summation order, and argmax-pixel ties for the colour.
TOL_CONTRIB = 1e-5
TOL_SURF = 1e-4
TOL_COLOUR = 1e-3
COLOUR_SHARE = 0.97
CPU4 = [torch.device("cpu")] * 4


def _scene(n, seed, spread, lo, hi, n_cams, width, height, focal, step, masks=None):
    """One scene for both packages: JAX arrays and cameras, and the same
    values as port tensors."""
    scene = make_synthetic_scene(n, seed=seed, spread=spread, scale_lo=lo, scale_hi=hi)
    transforms, intr = {}, {}
    for i in range(n_cams):
        c2w, intrinsic = look_at_camera(angle=i * step, width=width, height=height, focal=focal)
        transforms[f"c{i}"] = c2w.tolist()
        intr[f"c{i}"] = intrinsic
    jcams, wp, hp = jax_build_camera_batch(transforms, intr, masks=masks)
    arrays = (scene.xyz, scene.covariance_factors(), scene.opacities * 0.9, scene.colours,
              jnp.ones(n, bool))
    tscene = RenderArrays(*(torch.tensor(np.asarray(a)) for a in arrays))
    tcams = CameraBatch.from_jax_fields(jcams, wp, hp, device="cpu")
    return arrays, jcams, tscene, tcams, wp, hp


def _gauss_setup():
    """TestGaussShardedSweep._setup: 400 Gaussians, three 64x48 cameras."""
    return _scene(400, 31, 1.1, -3.2, -1.4, 3, 64, 48, 70.0, 1.7)


def _cfgs(wp, hp, run_cap=4096, run_chunk=128, n=400):
    # big_cap = P: the JAX pair budget keeps every window, so only the
    # run cap can drop pairs on either side.
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, big_cap=n, run_cap=run_cap,
                         run_chunk=run_chunk)
    return jcfg, R.TileConfig(width_pad=wp, height_pad=hp, run_cap=run_cap, run_chunk=run_chunk)


def _assert_close(jacc, tacc, tol_contrib=TOL_CONTRIB):
    np.testing.assert_allclose(tacc.max_contribution.numpy(),
                               np.asarray(jacc.max_contribution), atol=tol_contrib)
    np.testing.assert_allclose(tacc.total_contribution.numpy(),
                               np.asarray(jacc.total_contribution), atol=tol_contrib)
    a = np.asarray(jacc.min_surface_distance)
    b = tacc.min_surface_distance.numpy()
    np.testing.assert_array_equal(a < 3e38, b < 3e38)
    finite = a < 3e38
    np.testing.assert_allclose(b[finite], a[finite], atol=TOL_SURF)
    dc = np.abs(tacc.colours.numpy() - np.asarray(jacc.colours))
    assert (dc.max(axis=1) < TOL_COLOUR).mean() > COLOUR_SHARE
    assert dc.max() < 0.2


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_slab_assignment_matches_jax(n_dev):
    arrays, jcams, tscene, tcams, _, _ = _gauss_setup()
    for i in range(jcams.num_cameras):
        jcam, tcam = jcams.at(i), tcams.at(i)
        for d in range(n_dev):
            want = np.asarray(jax_gs._slab_mask(arrays[0], jcam.viewmatrix, arrays[4], d, n_dev))
            got = gauss_shard._slab_mask(tscene.means, tcam.viewmatrix, tscene.alive, d, n_dev)
            np.testing.assert_array_equal(got.numpy(), want)
    for p in (1, 100, 400, 3000, 1_000_000):
        for n in (1, 2, 3, 4, 8, 64):
            assert gauss_shard.slab_capacity(p, n) == jax_gs.slab_capacity(p, n)


@pytest.mark.parametrize("axis", ["cams", "gauss", "both"])
def test_sharded_sweep_matches_jax(axis):
    """Each sharded sweep on [cpu] * 4 against the JAX one on 4 devices."""
    arrays, jcams, tscene, tcams, wp, hp = _gauss_setup()
    jcfg, cfg = _cfgs(wp, hp)
    if axis == "cams":
        jacc = jax_render_sweep_sharded(arrays, jcams, jcfg, make_mesh(4))
        tacc = render_sweep_sharded(tscene, tcams, cfg, CPU4)
    elif axis == "gauss":
        jacc = jax_gs.render_sweep_gauss_sharded(arrays, jcams, jcfg, jax_gs.make_gauss_mesh(4))
        tacc = gauss_shard.render_sweep_gauss_sharded(tscene, tcams, cfg, CPU4)
    else:
        jmesh = jax_gs.make_2d_mesh(4)
        assert dict(jmesh.shape) == {"cams": 2, "gauss": 2}
        assert [len(r) for r in gauss_shard.grid_2d(CPU4)] == [2, 2]
        jacc = jax_gs.render_sweep_2d(arrays, jcams, jcfg, jmesh)
        tacc = gauss_shard.render_sweep_2d(tscene, tcams, cfg, CPU4)
    _assert_close(jacc, tacc)
    assert float(np.asarray(jacc.n_dropped)[1]) == 0.0  # JAX kept every window
    np.testing.assert_array_equal(tacc.n_dropped.numpy(), np.asarray(jacc.n_dropped))


def test_camera_sharded_sweep_equals_single_device():
    """Contiguous camera blocks keep the single sweep's winners: max,
    colour, surface distance and counters equal exactly."""
    _, _, tscene, tcams, wp, hp = _gauss_setup()
    _, cfg = _cfgs(wp, hp)
    one = render_sweep(tscene, tcams, cfg)
    two = render_sweep_sharded(tscene, tcams, cfg, [torch.device("cpu")] * 2)
    for name in ("max_contribution", "colours", "min_surface_distance", "n_dropped"):
        assert torch.equal(getattr(one, name), getattr(two, name)), name
    torch.testing.assert_close(two.total_contribution, one.total_contribution, atol=1e-5,
                               rtol=0)


def test_gauss_sharded_masks_match_jax():
    """Pixel masks compose with the slab split (TestGaussShardMasks' scene)."""
    rng = np.random.default_rng(0)
    masks = {f"c{i}": (rng.uniform(size=(48, 48)) > 0.4).astype(np.uint8) for i in range(2)}
    arrays, jcams, tscene, tcams, wp, hp = _scene(
        200, 41, 1.0, -3.2, -1.6, 2, 48, 48, 55.0, 2.1, masks=masks)
    assert tcams.mask is not None
    jcfg, cfg = _cfgs(wp, hp, n=200)
    jacc = jax_gs.render_sweep_gauss_sharded(arrays, jcams, jcfg, jax_gs.make_gauss_mesh(4))
    tacc = gauss_shard.render_sweep_gauss_sharded(tscene, tcams, cfg, CPU4)
    _assert_close(jacc, tacc)
    np.testing.assert_array_equal(tacc.n_dropped.numpy(), np.asarray(jacc.n_dropped))


def test_per_slab_run_cap_divergence_matches_jax():
    """A run cap the scene saturates applies per slab on both sides (the
    JAX package's divergence (b)): the sharded sweep blends more pairs and
    drops fewer than one device, by the same counts as in JAX."""
    arrays, jcams, tscene, tcams, wp, hp = _gauss_setup()
    jcfg, cfg = _cfgs(wp, hp, run_cap=64, run_chunk=64)
    j1 = jax_render_sweep(arrays, jcams, jcfg)
    jn = jax_gs.render_sweep_gauss_sharded(arrays, jcams, jcfg, jax_gs.make_gauss_mesh(4))
    t1 = render_sweep(tscene, tcams, cfg)
    tn = gauss_shard.render_sweep_gauss_sharded(tscene, tcams, cfg, CPU4)
    nd1, ndn = t1.n_dropped.numpy(), tn.n_dropped.numpy()
    np.testing.assert_array_equal(nd1, np.asarray(j1.n_dropped))
    np.testing.assert_array_equal(ndn, np.asarray(jn.n_dropped))
    assert nd1[2] > 0 and ndn[2] < nd1[2] and ndn[0] > nd1[0]
    _assert_close(jn, tn)
    d = np.abs(tn.max_contribution.numpy() - t1.max_contribution.numpy())
    assert (d > 1e-6).any()


@pytest.fixture(scope="module")
def splat_capture(tmp_path_factory):
    """TestGaussShardedSweep.test_pipeline_gauss_axis's capture: 300
    Gaussians in a .splat, three 64x48 cameras in a transforms.json."""
    import json

    from gs2pc.io.splat import save_splat

    root = tmp_path_factory.mktemp("splat_capture")
    scene = make_synthetic_scene(300, seed=32, spread=1.0, scale_lo=-3.4, scale_hi=-1.6)
    splat = str(root / "s.splat")
    save_splat(splat, np.asarray(scene.xyz), np.asarray(scene.log_scales),
               np.asarray(scene.rots), np.asarray(scene.colours), np.asarray(scene.opacities))
    frames = []
    for i in range(3):
        c2w, _ = look_at_camera(angle=i * 2.0, width=64, height=48, focal=70.0)
        frames.append({"file_path": f"images/c{i}.png", "transform_matrix": c2w.tolist(),
                       "w": 64, "h": 48, "fl_x": 70.0, "fl_y": 70.0})
    tpath = str(root / "transforms.json")
    with open(tpath, "w") as fh:
        json.dump({"frames": frames}, fh)
    return splat, tpath


def test_pipeline_gauss_axis_matches_jax(splat_capture, tmp_path, monkeypatch):
    """convert_3dgs_to_pc with --shard_axis gauss on four devices, both
    packages: the same accumulators, keep mask, quotas and u8 colours."""
    from gs2pc import pipeline as jax_pipeline
    from gs2pc.camera import build_camera_batch
    from gs2pc.io.colmap import load_transform_data as jax_load_transforms
    from gs2pc.io.gaussians_io import load_gaussians as jax_load_gaussians
    from gs2pc.utils.config import GaussPointCloudSettings
    from gs2pc_torch.camera import build_camera_batch as torch_build_camera_batch
    from gs2pc_torch.io.colmap import load_transform_data
    from gs2pc_torch.io.gaussians_io import load_gaussians

    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
    splat, tpath = splat_capture
    settings = GaussPointCloudSettings(num_points=5000, quiet=True, colour_resolution=None,
                                       surface_distance_std=1.0, shard_axis="gauss")

    transforms, intr = jax_load_transforms(tpath)
    jg = jax_load_gaussians(splat, compact_colours=True)
    jcams, wp, hp = build_camera_batch(transforms, intr)
    rc = settings.render
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, big_cap=jg.num_gaussians,
                         run_cap=rc.max_pairs_per_tile, run_chunk=rc.run_chunk, compact=True,
                         surface_compact=True)
    jacc = jax_pipeline.run_render_sweep(jg, jcams, jcfg, settings, num_devices=4)
    tg = load_gaussians(splat, compact_colours=True, device="cpu")
    tcams = torch_build_camera_batch(*load_transform_data(tpath), device="cpu")
    tacc = pipeline.run_render_sweep(tg, tcams, settings, CPU4)
    _assert_close(jacc, tacc)
    keep = np.asarray(jg.keep_mask & jax_pipeline.surface_keep_mask(jacc.min_surface_distance, 1.0)
                      & (jacc.max_contribution > settings.visibility_threshold))
    np.testing.assert_array_equal(pipeline.cull_chain(tg, tacc, settings).keep_mask.numpy(), keep)

    jpc, _ = jax_pipeline.convert_3dgs_to_pc(splat, tpath, None, settings, num_devices=4)
    res = pipeline.convert_3dgs_to_pc(splat, tpath, None, settings, device="cpu", num_devices=4)
    np.testing.assert_array_equal(np.asarray(jpc._counts), res.cloud.counts)
    np.testing.assert_array_equal(np.asarray(jpc._cols_u8), res.cloud.cols_u8)
    assert res.cloud.total == jpc.total > 0


def test_num_devices_rules(capsys):
    """0 means every local device (one CPU): a sharded axis then falls back
    to the camera axis with a warning; an explicit single device with a
    sharded axis raises; asking for more cards than exist raises."""
    cpu = torch.device("cpu")
    n, s = pipeline.resolve_num_devices(0, Settings(shard_axis="gauss"), cpu)
    assert (n, s.shard_axis) == (1, "cams")
    assert "--shard_axis gauss ignored" in capsys.readouterr().out
    n, s = pipeline.resolve_num_devices(1, Settings(shard_axis="both"), cpu)
    assert (n, s.shard_axis) == (1, "both")
    assert pipeline.resolve_num_devices(3, Settings(), cpu)[0] == 3
    _, _, tscene, tcams, _, _ = _gauss_setup()
    from gs2pc_torch.models.gaussians import Gaussians

    g = Gaussians(tscene.means, torch.zeros(400, 3), torch.zeros(400, 4), tscene.opacities,
                  tscene.colours, keep_mask=tscene.alive)
    with pytest.raises(ValueError, match="needs --num_devices > 1"):
        pipeline.run_render_sweep(g, tcams, Settings(shard_axis="gauss"), [cpu])
    too_many = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match=f"asks for {too_many} CUDA devices"):
        pipeline.sweep_devices(torch.device("cuda", 0), too_many)
    assert pipeline.sweep_devices(cpu, 3) == [cpu] * 3
