"""gs2pc_torch's CUDA kernels against their PyTorch twins, and the
conversion on a card.  Every test needs a CUDA device and nvcc and skips
without them.  The file imports no JAX, so it also runs on a GPU machine
that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gs2pc_torch import pipeline
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import blend_kernel as B
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.projection import preprocess
from gs2pc_torch.utils import capture
from gs2pc_torch.utils.config import GaussPointCloudSettings, RenderConfig

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

# Kernel vs twin: the same float operations in the same order; the
# exponentials may round differently.
TOL_IMAGE = 1e-5
TOL_CONTRIB = 1e-6
TOL_SURF = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(n, seed, device):
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    return Gaussians.from_numpy(
        r.uniform(-1.0, 1.0, (n, 3)), r.uniform(-3.5, -1.5, (n, 3)),
        q / np.linalg.norm(q, axis=1, keepdims=True), r.uniform(0, 1, (n, 3)),
        r.uniform(0.3, 0.9, n), device=device,
    )


def _camera(device, width=128, height=96, masked=True):
    c = np.array([0.0, 0.4, -4.0])
    z = -c / np.linalg.norm(c)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, c
    c2w[:, 1:3] = -c2w[:, 1:3]
    masks = None
    if masked:
        ys, xs = np.mgrid[0:height, 0:width]
        masks = {"cam": (((xs - width / 2) / (0.55 * width)) ** 2
                         + ((ys - height / 2) / (0.55 * height)) ** 2 <= 1).astype(np.uint8)}
    batch = build_camera_batch({"cam": c2w}, {"cam": (width, height, 150.0, 150.0)},
                               masks=masks, device=device)
    return batch, batch.at(0)


@pytest.mark.parametrize("surface", [True, False], ids=["full_rect", "circle_cull"])
def test_pairs_kernel_matches_twin(cuda, surface):
    g = _scene(3000, 1, cuda)
    batch, cam = _camera(cuda, masked=False)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad)
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=not surface)
    before = R.duplicate_with_keys.launches
    kk, kg = R.sort_pairs(*R.duplicate_with_keys(prep, cfg, not surface))
    assert R.duplicate_with_keys.launches == before + 2
    tk, tg = R.sort_pairs(*R.duplicate_with_keys_torch(prep, cfg, not surface))
    assert kk.numel() > 0
    assert torch.equal(kk, tk) and torch.equal(kg, tg)


@pytest.mark.parametrize("compact,surface_compact", [(True, True), (False, False)])
def test_blend_kernel_matches_twin(cuda, compact, surface_compact):
    g = _scene(3000, 2, cuda)
    batch, cam = _camera(cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad,
                       run_cap=512, compact=compact, surface_compact=surface_compact)
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True)
    before = B.blend_tiles.launches
    k = B.blend_tiles(*args, **kw)
    assert B.blend_tiles.launches == before + 1
    _assert_kernel_matches_twin(k, B.blend_tiles_torch(*args, **kw))


def _assert_kernel_matches_twin(k, t):
    for name in ("image", "depth", "invdepth", "trans", "live"):
        torch.testing.assert_close(getattr(k, name), getattr(t, name), atol=TOL_IMAGE, rtol=0)
    torch.testing.assert_close(k.chunks, t.chunks, atol=0, rtol=0)
    torch.testing.assert_close(k.contrib, t.contrib, atol=TOL_CONTRIB, rtol=0)
    torch.testing.assert_close(k.surf_dist, t.surf_dist, atol=TOL_SURF, rtol=0)
    hit = k.contrib > 0
    assert int(hit.sum()) > 100
    # The pixel can differ only on a near-tie of the pair's max contribution.
    assert float((k.best_pix != t.best_pix)[hit].float().mean()) < 1e-3


@pytest.mark.parametrize("mode", ["early_stop_off", "init_trans", "ed_override_compact",
                                  "ed_override_full", "black_background"])
def test_blend_kernel_modes_match_twin(cuda, mode):
    """K1's depth-slab modes against the twin: no stop with the final T,
    a seeded starting-T map with ~10% of pixels already below 1e-4, a
    surface-pass depth map under both surface_compact settings, bg = 0."""
    g = _scene(3000, 5, cuda)
    batch, cam = _camera(cuda)
    npx = batch.width_pad * batch.height_pad
    r = np.random.default_rng(7)
    t0 = r.uniform(0.0, 1.0, npx).astype(np.float32)
    t0[r.uniform(size=npx) < 0.1] = 1e-5
    modes = {
        "early_stop_off": dict(early_stop=False),
        "init_trans": dict(init_trans=torch.tensor(t0, device=cuda)),
        "ed_override_compact": dict(
            init_trans=torch.tensor(t0, device=cuda),
            ed_override=torch.tensor(r.uniform(2.0, 6.0, npx).astype(np.float32), device=cuda)),
        "ed_override_full": dict(
            ed_override=torch.tensor(r.uniform(2.0, 6.0, npx).astype(np.float32), device=cuda)),
        "black_background": dict(bg=0.0),
    }[mode]
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, run_cap=512,
                       compact=True, surface_compact=mode != "ed_override_full")
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True,
                                 **modes)
    before = dict(B.blend_tiles.launches_by_mode)
    k = B.blend_tiles(*args, **kw)
    name = B.mode_of(kw.get("init_trans"), kw.get("ed_override"), kw.get("early_stop", True))
    assert B.blend_tiles.launches_by_mode[name] == before.get(name, 0) + 1
    _assert_kernel_matches_twin(k, B.blend_tiles_torch(*args, **kw))


def test_render_tile_camera_on_card_matches_cpu(cuda):
    g_cpu = _scene(2000, 3, "cpu")
    g = _scene(2000, 3, cuda)
    batch_cpu, cam_cpu = _camera("cpu")
    _, cam = _camera(cuda)
    cfg = R.TileConfig(width_pad=batch_cpu.width_pad, height_pad=batch_cpu.height_pad,
                       compact=True, surface_compact=True)
    outs = [
        R.render_tile_camera(s.xyz, s.covariance_factors(), s.opacities, s.colours,
                             s.keep_mask, c, cfg)
        for s, c in ((g_cpu, cam_cpu), (g, cam))
    ]
    torch.testing.assert_close(outs[1].image.cpu(), outs[0].image, atol=TOL_IMAGE, rtol=0)
    torch.testing.assert_close(outs[1].contrib.cpu(), outs[0].contrib, atol=TOL_CONTRIB, rtol=0)
    torch.testing.assert_close(outs[1].n_dropped.cpu(), outs[0].n_dropped)


@pytest.mark.parametrize("axis", ["cams", "gauss", "both"])
def test_sharded_sweeps_on_card_match_cpu(cuda, axis):
    """The three sharded sweeps on [cuda:0] * 4 against the same sweeps on
    CPU tensors (the twins); the depth-slab path launches K1 3 D times per
    camera with the surface pass on."""
    from gs2pc_torch.parallel.gauss_shard import render_sweep_2d, render_sweep_gauss_sharded
    from gs2pc_torch.sweep import render_arrays, render_sweep_sharded

    sweep = {"cams": render_sweep_sharded, "gauss": render_sweep_gauss_sharded,
             "both": render_sweep_2d}[axis]
    transforms, intr = capture.make_poses(3, 128, 96, focal_scale=0.6)
    m = capture.vignette_mask(128, 96)
    accs = []
    for dev in ("cpu", cuda):
        g = _scene(2000, 6, dev)
        cams = build_camera_batch(transforms, intr, masks={n: m for n in transforms},
                                  device=dev)
        cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                           compact=True, surface_compact=True)
        before = B.blend_tiles.launches
        accs.append(sweep(render_arrays(g), cams, cfg, [torch.device(dev)] * 4))
        if dev != "cpu" and axis == "gauss":
            assert B.blend_tiles.launches - before == 3 * 4 * cams.num_cameras
    a, b = accs
    torch.testing.assert_close(b.max_contribution.cpu(), a.max_contribution, atol=TOL_CONTRIB,
                               rtol=0)
    torch.testing.assert_close(b.total_contribution.cpu(), a.total_contribution,
                               atol=TOL_CONTRIB, rtol=0)
    torch.testing.assert_close(b.min_surface_distance.cpu(), a.min_surface_distance,
                               atol=TOL_SURF, rtol=0)
    torch.testing.assert_close(b.n_dropped.cpu(), a.n_dropped)


def test_conversion_on_card(cuda, tmp_path):
    transforms, intr = capture.make_poses(3, 128, 96)
    ply, tj, masks = capture.write_capture(
        str(tmp_path), capture.make_scene_arrays(5000, seed=4), transforms, intr,
        with_masks=True,
    )
    settings = GaussPointCloudSettings(
        num_points=30_000, colour_resolution=None, quiet=True, surface_distance_std=1.0,
        render=RenderConfig(max_pairs_per_tile=256),
    )
    before = B.blend_tiles.launches
    result = pipeline.convert_3dgs_to_pc(ply, tj, masks, settings, device=cuda)
    assert B.blend_tiles.launches == before + 3
    cloud = result.cloud
    assert cloud.total == int(cloud.counts.sum()) > 0
    assert np.isfinite(cloud.points).all()
    ref = pipeline.convert_3dgs_to_pc(ply, tj, masks, settings, device="cpu")
    assert result.sweep_diag == ref.sweep_diag
    assert abs(cloud.total - ref.cloud.total) <= 0.001 * ref.cloud.total


@pytest.mark.parametrize("kind", ["ones", "uniform"])
def test_probe_op_kernel_matches_twin(cuda, kind):
    """K3, every op: launched once each, equal to the twin (bit for bit
    where both make the same operations, else within the tool's bound)."""
    from gs2pc_torch.ops import probe_kernels as PK
    from gs2pc_torch.tools import cuda_probe

    x = cuda_probe.make_input(kind, cuda, seed=3)
    for _, op in PK.PROBE_OPS:
        before = PK.probe_op.launches
        got = PK.probe_op(op, x)
        assert PK.probe_op.launches == before + 1
        want = PK.probe_op_torch(op, x)
        if op in PK.EXACT_OPS:
            assert torch.equal(got, want), op
        else:
            assert cuda_probe.rel_err(got, want) <= cuda_probe.RTOL, op


@pytest.mark.parametrize("kind", ["ones", "seeded"])
def test_probe_blend_kernel_matches_twin(cuda, kind):
    """K4, every level, through the tool's comparison (m / apix where the
    level writes them)."""
    from gs2pc_torch.ops import probe_kernels as PK
    from gs2pc_torch.tools import cuda_probe2

    inputs = cuda_probe2.make_inputs(kind, cuda, seed=5)
    for level in PK.LEVELS:
        before = PK.probe_blend.launches
        got = PK.probe_blend(level, *inputs)
        assert PK.probe_blend.launches == before + 1
        want = PK.probe_blend_torch(level, *inputs)
        assert cuda_probe2.compare(level, got, want) <= cuda_probe2.RTOL, level


def test_dense_oracle_on_card_matches_cpu(cuda):
    from gs2pc_torch.ops.dense_render import render_dense

    outs = []
    for dev in ("cpu", cuda):
        g = _scene(1500, 8, dev)
        batch, cam = _camera(dev, width=96, height=64)
        outs.append(render_dense(g.xyz, g.covariance_factors(), g.opacities, g.colours,
                                 g.keep_mask, cam, batch.width_pad, batch.height_pad,
                                 chunk=128, pixel_chunk=2048, mask=cam.mask, rect_cull=True))
    torch.testing.assert_close(outs[1].image.cpu(), outs[0].image, atol=TOL_IMAGE, rtol=0)
    torch.testing.assert_close(outs[1].contrib.cpu(), outs[0].contrib, atol=TOL_CONTRIB, rtol=0)
    torch.testing.assert_close(outs[1].surf_dist.cpu(), outs[0].surf_dist, atol=TOL_SURF, rtol=0)
