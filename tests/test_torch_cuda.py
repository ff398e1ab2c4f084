"""gs2pc_torch's CUDA kernels against their PyTorch twins, and the
conversion on a card.  Every test needs a CUDA device and nvcc and skips
without them.  The file imports no JAX, so it also runs on a GPU machine
that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gs2pc.utils.config import GaussPointCloudSettings, RenderConfig
from gs2pc_torch import pipeline
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import blend_kernel as B
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.projection import preprocess

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
    t = B.blend_tiles_torch(*args, **kw)
    for name in ("image", "depth", "invdepth", "trans", "live"):
        torch.testing.assert_close(getattr(k, name), getattr(t, name), atol=TOL_IMAGE, rtol=0)
    torch.testing.assert_close(k.contrib, t.contrib, atol=TOL_CONTRIB, rtol=0)
    torch.testing.assert_close(k.surf_dist, t.surf_dist, atol=TOL_SURF, rtol=0)
    hit = k.contrib > 0
    assert int(hit.sum()) > 100
    # The pixel can differ only on a near-tie of the pair's max contribution.
    assert float((k.best_pix != t.best_pix)[hit].float().mean()) < 1e-3


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


def test_conversion_on_card(cuda, tmp_path):
    import bench  # the benchmark's capture writer (numpy and PIL only)

    transforms, intr = bench.make_poses(3, 128, 96)
    ply, tj, masks = bench.write_capture(
        str(tmp_path), bench.make_scene_arrays(5000, seed=4), transforms, intr,
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
