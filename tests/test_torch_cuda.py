"""gs2pc_torch's CUDA kernels against their PyTorch twins, and the
conversion on a card.  Every test needs a CUDA device and nvcc and skips
without them.  The file imports no JAX, so it also runs on a GPU machine
that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from gs2pc_torch import pipeline
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import blend_kernel as B
from gs2pc_torch.ops import prng
from gs2pc_torch.ops import projection as PJ
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops import sampler as S
from gs2pc_torch.ops.projection import preprocess
from gs2pc_torch.parallel import mesh
from gs2pc_torch.utils import capture
from gs2pc_torch.utils.config import GaussPointCloudSettings, RenderConfig
from frontend_cases import CASES as K6_CASES
from frontend_cases import bits_differ, frontend_inputs
from ply_decode_cases import INRIA, assert_bits_equal, card_layout, records, write_ply

# frontend_cases and ply_decode_cases come from this directory (pytest puts
# it on sys.path): a GPU machine may have another top-level ``tests``
# package installed.
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
    order = R.depth_order(prep.depth, prep.valid)
    assert torch.equal(order.cpu(), R.depth_order(prep.depth.cpu(), prep.valid.cpu()))
    before = R.duplicate_with_keys.launches
    ut, ug = R.duplicate_with_keys(prep, cfg, not surface, order)
    assert R.duplicate_with_keys.launches == before + 2
    # The same pair at the same index before the tile sort: the twin's pairs
    # moved to the same rank order (duplicate_with_keys on CPU tensors).
    tt, tg = R.duplicate_with_keys(_on_cpu(prep), cfg, not surface, order.cpu())
    assert torch.equal(ut.cpu(), tt) and torch.equal(ug.cpu(), tg)
    st, sg = R.sort_by_tile(ut, ug, cfg.num_tiles)
    tk, tg = R.sort_pairs(*R.duplicate_with_keys_torch(prep, cfg, not surface))
    assert sg.numel() > 0
    assert torch.equal(st.long(), tk >> 32) and torch.equal(sg, tg)


def test_pairs_kernel_whole_screen_gaussian(cuda):
    """Full-rect K2 with one Gaussian on every tile of a 1280x720 camera
    among small and invalid ones (whose rects are garbage): the pair-parallel
    write puts every pair where the twin does, unsorted."""
    from gs2pc_torch.ops.projection import Preprocessed

    gw, gh = 80, 45
    r = np.random.default_rng(11)
    n = 4000
    x0 = r.integers(0, gw - 3, n)
    y0 = r.integers(0, gh - 3, n)
    rmin = np.stack([x0, y0], 1)
    rmax = rmin + r.integers(1, 4, (n, 2))
    rmin[7], rmax[7] = (0, 0), (gw, gh)
    valid = r.uniform(size=n) < 0.7
    valid[7] = True
    rmin[~valid] = r.integers(-50, 50, (int((~valid).sum()), 2))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    area = (rmax - rmin).prod(1) * valid
    prep = Preprocessed(
        depth=t(r.uniform(1, 9, n), torch.float32), xy=t(r.uniform(0, 1000, (n, 2)), torch.float32),
        conic=t(np.zeros((n, 3)), torch.float32), opacity=t(np.ones(n), torch.float32),
        radius=t(np.ones(n), torch.float32), r_alpha_sq=t(np.full(n, 3.4e38), torch.float32),
        radius_q=t(np.ones(n), torch.float32), rect_min=t(rmin, torch.int32),
        rect_max=t(rmax, torch.int32), tiles_touched=t(area, torch.int32), valid=t(valid, torch.bool))
    cfg = R.TileConfig(width_pad=16 * gw, height_pad=16 * gh)
    order = R.depth_order(prep.depth, prep.valid)
    ut, ug = R.duplicate_with_keys(prep, cfg, False, order)
    tt, tg = R.duplicate_with_keys(_on_cpu(prep), cfg, False, order.cpu())
    assert ut.numel() == int(area.sum()) >= gw * gh
    assert torch.equal(ut.cpu(), tt) and torch.equal(ug.cpu(), tg)
    _hold_order_pairs(prep, cfg, False)


def _on_cpu(prep):
    return type(prep)(*(t.cpu() for t in prep))


def _hold_order_pairs(prep, cfg, circle_cull: bool) -> int:
    """order_pairs on the card against the twin chain (the int64 key sort of
    the twin's gid-order pairs, then the gid gather): sorted gids, tile
    starts and runs bit-equal, two sorts launched.  Returns the pair count."""
    before = R.order_pairs.launches
    tiles, gids = R.order_pairs(prep, cfg, circle_cull)
    assert R.order_pairs.launches == before + 2
    keys, want_gids = R.sort_pairs(*R.duplicate_with_keys_torch(prep, cfg, circle_cull))
    torch.cuda.synchronize()
    assert tiles.dtype == gids.dtype == torch.int32
    assert torch.equal(gids, want_gids)
    got = R.tile_ranges(tiles, cfg.num_tiles)
    want = R.tile_ranges((keys >> 32).to(torch.int32), cfg.num_tiles)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return gids.numel()


@functools.lru_cache(maxsize=1)
def _e2e_arrays():
    """chip_smoke's e2e scene: 3M Gaussians of the capture kind."""
    return capture.make_scene_arrays(3_000_000)


@pytest.mark.parametrize("surface", [True, False], ids=["full_rect", "circle_cull"])
@pytest.mark.parametrize("where", ["camera_0", "slab_1_of_4"])
def test_order_pairs_matches_int64_key_sort(cuda, where, surface):
    """Camera 0 of the e2e scene (3M Gaussians, 1280x720, 3,600 tiles: two
    radix digits), whole or as depth slab 1 of 4 (gauss_shard's compaction):
    the depth sort, K2 in rank order and the tile sort give the int64 key
    sort's order exactly."""
    from gs2pc_torch.parallel import gauss_shard
    from gs2pc_torch.sweep import render_arrays

    a = _e2e_arrays()
    g = Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours, a.opacities, device=cuda)
    transforms, intr = capture.make_poses(1, 1280, 720)
    batch = build_camera_batch(transforms, intr, device=cuda)
    cam = batch.at(0)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad)
    scene = render_arrays(g)
    if where != "camera_0":
        scene = gauss_shard._compact(scene, cam, 1, 4, None).scene
    prep = preprocess(scene.means, scene.cov_factors, scene.opacities, scene.alive, cam,
                      adaptive_radius=not surface)
    assert _hold_order_pairs(prep, cfg, not surface) > 100_000


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


@pytest.mark.parametrize("run_chunk", [1, 128, 256])
def test_blend_kernel_run_chunk_matches_twin(cuda, run_chunk):
    g = _scene(3000, 9, cuda)
    batch, cam = _camera(cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, run_cap=512,
                       run_chunk=run_chunk, compact=True, surface_compact=True)
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True)
    _assert_kernel_matches_twin(B.blend_tiles(*args, **kw), B.blend_tiles_torch(*args, **kw))


def test_blend_kernel_more_tiles_than_blocks(cuda):
    """3,600 tiles at 1280x720, more than the resident blocks, launched in
    the wrapper's longest-run-first tile order."""
    g = _scene(3000, 10, cuda)
    batch, cam = _camera(cuda, width=1280, height=720)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, run_cap=1024,
                       compact=True, surface_compact=True)
    assert cfg.num_tiles > 132 * 8
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True)
    _assert_kernel_matches_twin(B.blend_tiles(*args, **kw), B.blend_tiles_torch(*args, **kw))


def _direct_blend(cuda, rows, n_run, mask, run_chunk=128, surface_compact=True):
    """K1 and its twin on hand-made inputs: a 2x2-tile image whose every tile
    runs Gaussians 0..n_run-1 of the compact table ``rows``."""
    gw = gh = 2
    num_tiles = gw * gh
    table = torch.tensor(np.asarray(rows, np.float32), device=cuda)
    gid = torch.arange(n_run, dtype=torch.int32, device=cuda).repeat(num_tiles)
    starts = torch.arange(num_tiles, dtype=torch.int32, device=cuda) * n_run
    counts = torch.full((num_tiles,), n_run, dtype=torch.int32, device=cuda)
    m = torch.tensor(mask.reshape(-1), dtype=torch.uint8, device=cuda)
    kw = dict(width=16 * gw, height=16 * gh, width_pad=16 * gw, height_pad=16 * gh,
              run_chunk=run_chunk, with_surface=True, surface_compact=surface_compact)
    args = (table, gid, starts, counts, m)
    return B.blend_tiles(*args, **kw), B.blend_tiles_torch(*args, **kw)


def _rows(r, n, opacity, conic=0.002):
    rgb = r.integers(0, 1 << 24, n).astype(np.float32)
    return np.stack([r.uniform(0, 32, n), r.uniform(0, 32, n), np.full(n, conic), np.zeros(n),
                     np.full(n, conic), opacity, np.linspace(1.0, 9.0, n), rgb], 1)


@pytest.mark.parametrize("case", ["cap_low_opacity", "ties", "all_masked_tile", "cull_shapes"])
def test_blend_kernel_edge_cases_match_twin(cuda, case):
    """A run at the 4,096 cap that never stops; exact ties of w inside a warp
    and across warps (the lowest padded pixel wins); a tile whose pixels are
    all masked though its run is not empty; the shapes the kernel's warp
    cull must get right (sub-pixel splats, near-degenerate conics, opacity
    below 1/255), which the twin does not cull."""
    r = np.random.default_rng(12)
    mask = np.ones((32, 32), np.uint8)
    if case == "cull_shapes":
        rows = np.concatenate([
            _rows(r, 200, r.uniform(0.5, 0.99, 200), conic=2.0),
            _rows(r, 50, r.uniform(0.3, 0.9, 50), conic=0.01),
            _rows(r, 50, r.uniform(0.001, 0.0039, 50), conic=0.002),
        ])
        rows[200:250, 3] = 0.00999 * r.choice([-1.0, 1.0], 50)  # det ~ 2e-7
        rows = rows[r.permutation(300)]
        rows[:, 6] = np.linspace(1.0, 9.0, 300)
        k, t = _direct_blend(cuda, rows, 300, mask)
    elif case == "cap_low_opacity":
        # alpha ~ 0.001-0.006: about a third of the pairs blend, T stays > 1e-4.
        k, t = _direct_blend(cuda, _rows(r, 4096, r.uniform(0.001, 0.006, 4096)), 4096, mask)
        assert torch.equal(k.chunks, torch.full_like(k.chunks, 32))
        assert float(k.live.max()) > 1e-4
    elif case == "ties":
        rows = _rows(r, 300, r.uniform(0.01, 0.1, 300))
        # Gaussians 0 and 1 have a flat footprint: alpha 0.5, then 0.2, on
        # every pixel, so every pixel ties.  The first two rows (warp 0 of
        # tiles 0 and 1) and five pixels of the third are masked: the winner
        # is lane 5 of warp 1 of tile 0.
        rows[:2, 2:5] = 0.0
        rows[0, 5], rows[1, 5] = 0.5, 0.2
        mask[:2, :] = 0
        mask[2, :5] = 0
        k, t = _direct_blend(cuda, rows, 300, mask, surface_compact=False)
        want = 2 * 32 + 5
        assert int(k.best_pix[0]) == want and int(k.best_pix[1]) == want
        assert torch.equal(k.best_pix, t.best_pix)
    else:
        mask[:16, 16:] = 0  # tile 1
        k, t = _direct_blend(cuda, _rows(r, 500, r.uniform(0.01, 0.1, 500)), 500, mask,
                             surface_compact=False)
        assert int(k.chunks[1]) == 0
    _assert_kernel_matches_twin(k, t)


def test_camera_without_pairs_on_card(cuda):
    """Every Gaussian culled: K2 writes nothing and K1 blends empty runs."""
    g = _scene(500, 13, cuda)
    batch, cam = _camera(cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad)
    alive = torch.zeros_like(g.keep_mask)
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, alive, cam,
                      adaptive_radius=False)
    tiles, gids = R.duplicate_with_keys(prep, cfg, False, R.depth_order(prep.depth, prep.valid))
    assert tiles.numel() == 0 and gids.numel() == 0
    assert _hold_order_pairs(prep, cfg, False) == 0
    out = R.render_tile_camera(g.xyz, g.covariance_factors(), g.opacities, g.colours, alive,
                               cam, cfg)
    valid = cam.mask.reshape(batch.height_pad, batch.width_pad) != 0
    assert float(out.contrib.abs().max()) == 0.0
    assert torch.equal(out.image[valid], torch.ones_like(out.image[valid]))
    assert bool((out.surf_dist == B.FLOAT_MAX).all())


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
    before_k5 = S.sample_points.launches
    before_sorts = R.order_pairs.launches
    result = pipeline.convert_3dgs_to_pc(ply, tj, masks, settings, device=cuda)
    assert B.blend_tiles.launches == before + 3
    assert S.sample_points.launches == before_k5 + 1
    # Every camera took the depth-first order: its depth sort and tile sort.
    assert R.order_pairs.launches == before_sorts + 2 * 3
    cloud = result.cloud
    assert cloud.total == int(cloud.counts.sum()) > 0
    assert np.isfinite(cloud.points).all()
    ref = pipeline.convert_3dgs_to_pc(ply, tj, masks, settings, device="cpu")
    assert result.sweep_diag == ref.sweep_diag
    assert abs(cloud.total - ref.cloud.total) <= 0.001 * ref.cloud.total


def test_bench_on_card(cuda, tmp_path, monkeypatch, capsys):
    """The port's bench at a tiny size on the card: exit 0, K1 and K5 ran
    (blend "cuda", sampler "k5"), the card named with its power limit."""
    import json

    from gs2pc_torch import bench

    for key, value in dict(GS2PC_BENCH_GAUSSIANS="256", GS2PC_BENCH_POINTS="4000",
                           GS2PC_BENCH_CAMERAS="2", GS2PC_BENCH_WIDTH="64",
                           GS2PC_BENCH_HEIGHT="48", GS2PC_BENCH_PSNR_GAUSS="256",
                           GS2PC_CACHE_DIR=str(tmp_path / "cache"),
                           GS2PC_BENCH_DIR=str(tmp_path / "bench")).items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("GS2PC_BENCH_DEVICE", raising=False)
    monkeypatch.delenv("GS2PC_BENCH_SCENE", raising=False)
    assert bench.main() == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (rec["blend"], rec["sampler"], rec["steady"]) == ("cuda", "k5", True)
    assert rec["device"] == f"gpu:{torch.cuda.get_device_name(0)}" and rec["power_limit"]
    assert rec["peak_device_bytes"] > 0 and rec["psnr_gate_pass"] is True


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


def _k4_inputs(device, counts, x=None, opacity=None, num_tiles=None, masked=(), mask_off=0.1,
               seed=7):
    """K4 inputs with one 256-column window per tile (runs of up to 256 pairs):
    x and opacity (L,) default to the seeded tool input's draws; a share
    mask_off of the pixels is masked, and every pixel of the tiles in
    masked."""
    from gs2pc_torch.ops import probe_kernels as PK

    r = np.random.default_rng(seed)
    n = len(counts)
    L = 2 * PK.RS * PK.NTP
    table = r.uniform(0.0, 1.0, (16, L)).astype(np.float32)
    table[0] = r.uniform(0.0, 64.0, L) if x is None else x
    table[5] = r.uniform(0.05, 0.95, L) if opacity is None else opacity
    mask = (r.uniform(size=(n, PK.TPX, 1)) >= mask_off).astype(np.uint8)
    for t in masked:
        mask[t] = 0
    arrays = (np.arange(n, dtype=np.int32) * 2 * PK.RS, np.asarray(counts, np.int32),
              np.array([64, 64, n if num_tiles is None else num_tiles, 1], np.int32), table, mask)
    return tuple(torch.tensor(a, device=device) for a in arrays)


def _k4_edge_case(case, device):
    """(inputs, the (tile, lane) whose apix level 5 must give, its pixel in
    the tile) for one edge of K4's lane / warp / cluster layout."""
    from gs2pc_torch.ops import probe_kernels as PK

    L = 2 * PK.RS * PK.NTP
    if case == "runs":  # chunk and segment edges of the run length
        return _k4_inputs(device, [1, 31, 32, 33, 127, 129, 128, 255, 256, 0] + [64] * 6), None
    if case == "stops":
        # Tile t: lanes below 32 (t % 4) + 5 lie far off; from there on every
        # x sits on the tile's column 7, so that column's pixels (alpha 0.99)
        # stop at lane 32 (t % 4) + 7, in segment t % 4, and their neighbours
        # later.
        x = np.full(L, -1000.0, np.float32)
        for t in range(PK.NTP):
            lanes = np.arange(2 * PK.RS)
            near = lanes % PK.RS >= 32 * (t % 4) + 5
            x[t * 2 * PK.RS + lanes[near]] = (t % PK.GRID_W) * 16 + 7
        return _k4_inputs(device, [2 * PK.RS] * PK.NTP, x=x,
                          opacity=np.full(L, 0.99, np.float32)), None
    if case == "ties":
        # x halfway between columns 7 and 8: pixels 7 and 8 of every row tie
        # (warps 7 and 0 of a CTA, rows across the cluster's CTAs); the
        # lowest, pixel 7 of row 0, must win lane 0.
        x = np.array([(t % PK.GRID_W) * 16 + 7.5 for t in range(PK.NTP)
                      for _ in range(2 * PK.RS)], np.float32)
        inputs = _k4_inputs(device, [PK.RS] * PK.NTP, x=x, opacity=np.ones(L, np.float32),
                            mask_off=0.0)
        return inputs, (5, 7)
    if case == "masked":
        return _k4_inputs(device, [2 * PK.RS] * PK.NTP, masked=(2, 7, 8)), None
    if case == "few_tiles":
        return _k4_inputs(device, [200, 256, 77, 256, 128], num_tiles=3, masked=(1,)), None
    raise ValueError(case)


@pytest.mark.parametrize("case", ["runs", "stops", "ties", "masked", "few_tiles"])
def test_probe_blend_kernel_edges(cuda, case):
    """K4 on the edges of its layout -- runs ending on either side of a
    32-lane segment and a 128-lane chunk, a pixel stopping in each segment,
    ties of w across warps and CTAs, fully masked tiles, fewer tiles than 16
    and tiles past num_tiles -- every level held to the twin."""
    from gs2pc_torch.ops import probe_kernels as PK
    from gs2pc_torch.tools import cuda_probe2

    inputs, tie = _k4_edge_case(case, cuda)
    starts, counts, dims, table, mask = inputs
    outs = {}
    for level in PK.LEVELS:
        got = PK.probe_blend(level, *inputs)
        want = PK.probe_blend_torch(level, *inputs)
        assert cuda_probe2.compare(level, got, want) <= cuda_probe2.RTOL, level
        outs[level] = got
    m = outs[5].m[0].cpu()
    for t in range(starts.numel()):
        cols = slice(int(starts[t]), int(starts[t]) + int(counts[t]))
        dead = (mask[t] == 0).all() or t >= int(dims[2]) or int(counts[t]) == 0
        # A tile with no valid pixel enters no chunk; the others write m.
        assert bool(torch.isnan(m[cols]).all()) == dead, t
    if tie is not None:
        t, px = tie
        lane0 = int(starts[t])
        ty, tx = divmod(t, PK.GRID_W)
        assert float(m[lane0]) > 0.0
        assert int(outs[5].apix[0, lane0]) == (ty * 16 + px // 16) * PK.WIDTH_PAD + tx * 16 + px % 16
    if case == "stops":
        # The stop fired on every tile: level 3 blends less than level 2.
        less = outs[2].rgb[..., 1] > outs[3].rgb[..., 1]
        assert bool(less.any(dim=1).all())


@pytest.mark.parametrize("op", ["min", "roll", "scan"])
def test_probe_op_kernel_exact_on_negative_values(cuda, op):
    """K3's exact ops on a block of mixed signs equal the twin bit for bit."""
    from gs2pc_torch.ops import probe_kernels as PK

    x = torch.tensor(np.random.default_rng(4).uniform(-1.5, 1.5, (PK.TPX, PK.RS)).astype(np.float32),
                     device=cuda)
    assert torch.equal(PK.probe_op(op, x), PK.probe_op_torch(op, x))


def test_probe_op_kernel_takes_an_unaligned_view(cuda):
    """A block that starts 4 bytes into its storage still runs (the wrapper
    copies it to 16-byte alignment)."""
    from gs2pc_torch.ops import probe_kernels as PK
    from gs2pc_torch.tools import cuda_probe

    big = cuda_probe.make_input("uniform", cuda, seed=6).reshape(-1)
    x = torch.cat([big, big[:1]])[1:].reshape(PK.TPX, PK.RS)
    assert x.data_ptr() % 16 != 0
    for op in PK.EXACT_OPS:
        assert torch.equal(PK.probe_op(op, x), PK.probe_op_torch(op, x)), op


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


def test_blend_kernel_sh_table_matches_twin(cuda):
    """K1 on the table of one camera's SH colours (per-camera rgb24 lanes)."""
    from gs2pc_torch.ops.sh import view_colours

    g = _scene(3000, 9, cuda)
    r = np.random.default_rng(9)
    coeffs = torch.tensor(r.normal(scale=0.3, size=(3000, 3, 16)), dtype=torch.float32,
                          device=cuda)
    batch, cam = _camera(cuda)
    colours = view_colours(3, coeffs, g.xyz, cam.campos)
    assert float((colours - g.colours).abs().max()) > 0.1
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad,
                       run_cap=512, compact=True, surface_compact=True)
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, colours, cam, cfg, calc_surface_distance=True)
    before = B.blend_tiles.launches
    k = B.blend_tiles(*args, **kw)
    assert B.blend_tiles.launches == before + 1
    _assert_kernel_matches_twin(k, B.blend_tiles_torch(*args, **kw))


def test_outlier_mask_on_card_matches_cpu(cuda):
    """The cleaning's Morton-window kNN on the card: distances within 1e-6
    relative of the CPU's, masks equal away from the threshold."""
    from gs2pc_torch import meshing

    r = np.random.default_rng(10)
    pts = r.normal(scale=0.3, size=(50_000, 3)).astype(np.float32)
    pts[:50] = r.uniform(-20, 20, (50, 3))
    d_cpu = meshing.knn_mean_distance(torch.tensor(pts))
    d_gpu = meshing.knn_mean_distance(torch.tensor(pts, device=cuda)).cpu()
    torch.testing.assert_close(d_gpu, d_cpu, rtol=1e-6, atol=0)
    for ratio in (10.0, 3.0):
        k_cpu = meshing.statistical_outlier_mask(torch.tensor(pts), std_ratio=ratio)
        k_gpu = meshing.statistical_outlier_mask(torch.tensor(pts, device=cuda),
                                                 std_ratio=ratio).cpu()
        d = d_cpu.double()
        thr = d.mean() + ratio * d.std(correction=0)
        near = (d - thr).abs() <= 1e-6 * thr
        assert torch.equal(k_gpu[~near], k_cpu[~near])
        assert int((~k_cpu).sum()) >= 50


def test_from_covariances_on_card_matches_cpu(cuda):
    """Sigma from the factors within 1e-5 relative of the CPU's; keep masks
    equal (from_covariances repairs in float64, so neither device's
    rounding decides them)."""
    from gs2pc_torch.ops.linalg3 import bmm33_nt
    from gs2pc_torch.ops.quaternion import quat_to_rotmat

    r = np.random.default_rng(11)
    n = 4096
    q = r.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R3 = quat_to_rotmat(torch.tensor(q)).numpy()
    lam = np.sort(np.exp(2.0 * r.uniform(-5.0, -2.0, (n, 3))), axis=1)
    lam[::2, 0] = -r.uniform(1e-6, 1e-3, n // 2)
    sigma = np.einsum("nij,nj,nkj->nik", R3, lam, R3).astype(np.float32)
    xyz = r.normal(size=(n, 3)).astype(np.float32)
    cols, opac = r.uniform(size=(n, 3)).astype(np.float32), r.uniform(size=n).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        g = Gaussians.from_covariances(xyz, sigma, cols, opac, device=dev)
        M = g.covariance_factors()
        out.append((bmm33_nt(M, M).cpu(), g.keep_mask.cpu()))
    scale = out[0][0].abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((out[1][0] - out[0][0]).abs() <= 1e-5 * scale).all())
    assert torch.equal(out[1][1], out[0][1])


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("axis", ["cams", "gauss", "both"])
def test_sharded_sweeps_on_card_equal_one_device(cuda, axis, n_dev):
    """The sweeps on [cuda:0] * n on the dry run's scene and cameras (no
    pair reaches the run cap): the same bits twice, and held to the
    one-device sweep as the dry run holds them."""
    from gs2pc_torch.parallel import dryrun
    from gs2pc_torch.parallel.gauss_shard import render_sweep_2d, render_sweep_gauss_sharded
    from gs2pc_torch.sweep import render_arrays, render_sweep, render_sweep_sharded

    sweep = {"cams": render_sweep_sharded, "gauss": render_sweep_gauss_sharded,
             "both": render_sweep_2d}[axis]
    scene = render_arrays(dryrun.tiny_scene(device=cuda))
    cams = dryrun.tiny_cameras(3, device=cuda)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad, compact=True,
                       surface_compact=True)
    acc = sweep(scene, cams, cfg, [cuda] * n_dev)
    again = sweep(scene, cams, cfg, [cuda] * n_dev)
    for name in dryrun.ACCUMULATORS:
        assert torch.equal(getattr(acc, name), getattr(again, name)), name
    one = render_sweep(scene, cams, cfg)
    d = dryrun.accumulator_diffs(acc, one)
    assert dryrun._exact_ok(d) if axis == "cams" else dryrun._slab_ok(d, acc, one), d


def test_render_preview_on_card_equals_render_camera(cuda, tmp_path):
    from gs2pc_torch.sweep import render_camera
    from gs2pc_torch.tools import render_preview
    from gs2pc_torch.utils.imaging import imread_png, to_u8

    transforms, intr = capture.make_poses(2, 128, 96)
    ply, tj, _ = capture.write_capture(str(tmp_path), capture.make_scene_arrays(5000, seed=4),
                                       transforms, intr, with_masks=False)
    out = tmp_path / "previews"
    before = (B.blend_tiles.launches, R.duplicate_with_keys.launches, R.order_pairs.launches)
    written = render_preview.main(["--input_path", ply, "--transform_path", tj, "--out_dir",
                                   str(out), "--colour_quality", "original", "--depth",
                                   "--device", "cuda:0"])
    assert len(written) == 4
    launched = (B.blend_tiles.launches - before[0], R.duplicate_with_keys.launches - before[1],
                R.order_pairs.launches - before[2])
    assert launched == (2, 4, 4)
    scene = render_preview.scene_arrays(render_preview.load_gaussians(ply, device=cuda))
    cams = build_camera_batch(*render_preview.load_transform_data(tj), device=cuda)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    for i, name in enumerate(sorted(transforms)):
        cam = cams.at(i)
        o = render_camera(scene, cam, cfg, calc_surface_distance=False)
        h, w = cam.height, cam.width
        np.testing.assert_array_equal(imread_png(str(out / f"{name}.png")),
                                      to_u8(o.image[:h, :w].cpu().numpy()))
        np.testing.assert_array_equal(
            imread_png(str(out / f"{name}_depth.png")),
            to_u8(render_preview.normalised_depth(o.depth[:h, :w].cpu().numpy())))


# K5's tile (csrc/sampler.cu, K5_TILE): the new cases place their edges by it.
K5_TILE = 1024
# Gaussians of the K5 cases' scene, by case (300 otherwise).
K5_SCENES = {"block_mid_tile": 6000, "all_centres": 5000, "zero_quota_gaps": 20_000}


def _k5_case(case: str, device):
    """(scene, quotas, n_cap, std, block) of a K5 edge case."""
    n_g = K5_SCENES.get(case, 300)
    g = _scene(n_g, 8, device)
    ppg = torch.tensor(np.random.default_rng(9).integers(0, 7, n_g), dtype=torch.int32)
    n_cap, std, block = int(ppg.sum()), 2.0, None
    if case == "one_slot":
        ppg = torch.zeros(300, dtype=torch.int32)
        ppg[17] = 1
        n_cap = 1
    elif case == "block_edge_in_a_run":
        start = int(ppg[:40].sum())
        ppg[40] = 9
        n_cap = int(ppg.sum())
        block = (start + 4, n_cap - 3)
    elif case == "all_quotas_zero_but_one":
        ppg = torch.zeros(300, dtype=torch.int32)
        ppg[299] = 5000
        n_cap = 5000
    elif case == "counters_above_2_32":
        # Slots past 2^32 (normals' counters past 2^33): only the block is drawn.
        ppg = torch.zeros(300, dtype=torch.int32)
        ppg[3], ppg[150], ppg[151] = 2**31 - 1, 2**31 - 1, 2**31 - 1
        n_cap = int(ppg.long().sum())
        lo = (1 << 32) + 5
        block = (lo - 2000, lo + 3000)
    elif case == "run_across_tiles":
        # A run of 3M slots: thousands of tiles, several strides of the
        # persistent grid (about one wave of CTAs).
        ppg[40] = 3_000_000
        n_cap = int(ppg.sum())
    elif case == "block_mid_tile":
        block = (3 * K5_TILE + 100, 9 * K5_TILE + 555)
    elif case == "all_centres":
        ppg = torch.ones(n_g, dtype=torch.int32)
        n_cap = n_g
    elif case == "no_centre_block":
        start = int(ppg[:40].sum())
        ppg[40] = 100_000
        n_cap = int(ppg.sum())
        block = (start + 10, start + 90_000)
    elif case == "zero_quota_gaps":
        # One Gaussian in 1500 has a quota: a tile's owners lie further apart
        # than the prefix window K5 keeps in shared memory.
        ppg = torch.where(torch.arange(n_g) % 1500 == 7, 3, 0).to(torch.int32)
        n_cap = int(ppg.sum())
    elif case.startswith("std_"):
        std = float(case[4:])
    return g, ppg.to(device), n_cap, std, block


@pytest.mark.parametrize("case", ["one_slot", "block_edge_in_a_run", "all_quotas_zero_but_one",
                                  "std_1e6", "counters_above_2_32", "run_across_tiles",
                                  "block_mid_tile", "all_centres", "no_centre_block",
                                  "zero_quota_gaps", "std_0.1", "std_15.9", "std_16", "std_17"])
def test_sampler_kernel_matches_twin(cuda, case):
    """K5 against its twin on the card, bit for bit: the same owners and the
    same points, one launch per call."""
    g, ppg, n_cap, std, block = _k5_case(case, cuda)
    key = prng.PRNGKey(4)
    before = S.sample_points.launches
    k = S.sample_points(key, g, ppg, n_cap, std, block=block)
    assert S.sample_points.launches == before + 1
    t = S.sample_points_torch(key, g, ppg, n_cap, std, block=block)
    torch.cuda.synchronize()
    lo, hi = block or (0, n_cap)
    assert k.points.shape == (hi - lo, 3) and bool(torch.isfinite(k.points).all())
    assert torch.equal(k.gaussian_idx, t.gaussian_idx)
    assert torch.equal(k.points, t.points)


def test_sampler_kernel_blocks_equal_the_whole(cuda):
    """Blocks of a split concatenate to the whole range (the point-axis
    split of an SPMD conversion), and an empty block launches nothing."""
    g, ppg, n_cap, _, _ = _k5_case("std_1e6", cuda)
    key = prng.PRNGKey(6)
    whole = S.sample_points(key, g, ppg, n_cap).points
    for parts in (2, 3, 7):
        blocks = [S.sample_points(key, g, ppg, n_cap, block=b).points
                  for b in mesh.split_evenly(n_cap, parts)]
        assert torch.equal(torch.cat(blocks), whole)
    before = S.sample_points.launches
    assert S.sample_points(key, g, ppg, n_cap, block=(n_cap, n_cap)).points.shape == (0, 3)
    assert S.sample_points.launches == before


def _lazy_case(device, n_gauss=3000, seed=11, with_normals=True):
    """(lazy cloud on ``device``, its host points, counts, colours, normals):
    counts in 0..8 with every fifth Gaussian empty."""
    r = np.random.default_rng(seed)
    counts = r.integers(0, 9, n_gauss).astype(np.int64)
    counts[::5] = 0
    total = int(counts.sum())
    pts = r.standard_normal((total, 3)).astype(np.float32)
    cols = r.integers(0, 256, (n_gauss, 3)).astype(np.uint8)
    nrm = r.standard_normal((n_gauss, 3)).astype(np.float32) if with_normals else None
    cloud = pipeline.LazyPointCloud(torch.tensor(pts, device=device), counts, cols, nrm, total)
    return cloud, pts, counts, cols, nrm


@pytest.mark.parametrize("chunk", ["7", "1000", "total+1"])
def test_lazy_cloud_streams_the_eager_bytes_on_card(cuda, tmp_path, chunk):
    """A lazy cloud on the card streams the eager writer's bytes through the
    native session, at chunks of 7 and 1000 rows and one chunk past the
    whole cloud."""
    from gs2pc_torch.io.ply import PointCloud, save_point_cloud_ply

    cloud, pts, counts, cols, nrm = _lazy_case(cuda)
    rows = cloud.total + 1 if chunk == "total+1" else int(chunk)
    lazy, eager = str(tmp_path / "lazy.ply"), str(tmp_path / "eager.ply")
    assert save_point_cloud_ply(cloud, lazy, chunk_size=rows) == "native_stream"
    assert save_point_cloud_ply(PointCloud(pts, counts, cols, nrm), eager,
                                chunk_size=rows) == "native_expand"
    assert open(lazy, "rb").read() == open(eager, "rb").read()


def test_lazy_cloud_stages_through_pinned_buffers_on_a_side_stream(cuda):
    """The chunks reach the host through pinned buffers, copied on a stream
    other than the one that made the points; two buffers take turns."""
    cloud, pts, *_ = _lazy_case(cuda)
    seen = []
    for lo, part in cloud.point_rows(1000):
        host = torch.from_numpy(part)
        assert host.is_pinned()
        np.testing.assert_array_equal(part, pts[lo:lo + part.shape[0]])
        seen.append(host.data_ptr())
    assert len(seen) > 2 and len(set(seen)) == 2
    assert cloud._copy_stream is not None
    assert cloud._copy_stream != torch.cuda.current_stream(cuda)
    assert cloud._copy_stream != torch.cuda.default_stream(cuda)


def test_k5_output_streams_without_a_sync(cuda, tmp_path):
    """K5's points, sampled on a side stream and streamed to the writer at
    once with no synchronise, write the bytes of the synchronised copy: the
    copy stream waits for the stream that made the points."""
    from gs2pc_torch.io.ply import PointCloud, save_point_cloud_ply

    g = _scene(20_000, 12, cuda)
    ppg = torch.tensor(np.random.default_rng(13).integers(0, 60, 20_000), dtype=torch.int32,
                       device=cuda)
    n_cap = int(ppg.sum())
    counts = ppg.long().cpu().numpy()
    cols = np.random.default_rng(14).integers(0, 256, (20_000, 3)).astype(np.uint8)
    torch.cuda.synchronize()
    producer = torch.cuda.Stream(cuda)
    with torch.cuda.stream(producer):
        before = S.sample_points.launches
        points = S.sample_points(prng.PRNGKey(5), g, ppg, n_cap).points
        assert S.sample_points.launches == before + 1
        cloud = pipeline.LazyPointCloud(points, counts, cols, None, n_cap)
    lazy, synced = str(tmp_path / "lazy.ply"), str(tmp_path / "synced.ply")
    assert save_point_cloud_ply(cloud, lazy, chunk_size=100_000) == "native_stream"
    torch.cuda.synchronize()
    save_point_cloud_ply(PointCloud(points.cpu().numpy(), counts, cols, None), synced,
                         chunk_size=100_000)
    assert open(lazy, "rb").read() == open(synced, "rb").read()


@pytest.mark.parametrize("case", ["rgb", "rgb_compact", "sh", "sh_with_shs", "sh_compact",
                                  "splat", "splat_compact"])
def test_hooked_upload_equals_from_numpy_on_card(cuda, tmp_path, monkeypatch, case):
    """load_gaussians on the card (an RGB .ply parsed into the pinned host
    planes it allocates, a .splat copied into them after its parse, each
    uploaded from there once the parse has ended; an SH .ply decoded on the
    card, only its opacities through a pinned host plane) gives from_numpy's
    scene of the parsed arrays bit for bit, usable on the current stream
    without a synchronise; the record decode runs only for the SH .ply."""
    from gs2pc_torch.io import gaussians_io
    from gs2pc_torch.io.splat import load_splat_gaussians, save_splat
    from gs2pc_torch.ops import plydecode

    pinned = []
    real = gaussians_io._HostPlanes.__call__

    def alloc(self, name, shape):
        plane = real(self, name, shape)
        pinned.append((name, self.tensors[name].is_pinned()))
        return plane

    monkeypatch.setattr(gaussians_io._HostPlanes, "__call__", alloc)

    a = capture.make_scene_arrays(50_000, seed=15)
    kind = case.split("_")[0]
    path = str(tmp_path / ("scene.splat" if kind == "splat" else "scene.ply"))
    if kind == "rgb":
        capture.write_scene_ply(path, a)
    elif kind == "splat":
        save_splat(path, a.xyz, a.log_scales, a.rots, a.colours, a.opacities)
    else:
        _write_sh_ply(path, a)
    compact, with_shs = case.endswith("compact"), case.endswith("with_shs")
    before = plydecode.ply_decode.launches
    got = gaussians_io.load_gaussians(path, compact_colours=compact, with_shs=with_shs,
                                      device=cuda)
    decoded = plydecode.ply_decode.launches - before
    names = ["xyz", "opacities", "colours"] + ["shs"] * with_shs + ["log_scales", "rots"]
    assert [n for n, _ in pinned] == (["opacities"] if kind == "sh" else names)
    assert all(p for _, p in pinned), pinned
    assert decoded == (-(-50_000 // gaussians_io.CARD_BLOCK_ROWS) if kind == "sh" else 0)
    parsed = (load_splat_gaussians(path) if kind == "splat"
              else gaussians_io.load_ply_gaussians(path))
    xyz, ls, rots, cols, op, shs = parsed
    if compact:
        cols = gaussians_io.quantise_colours_u8(cols)
    want = Gaussians.from_numpy(xyz, ls, rots, cols, op, shs=shs if with_shs else None,
                                device=cuda)
    for name in ("xyz", "log_scales", "rots", "opacities", "colours", "shs", "keep_mask"):
        x, y = getattr(got, name), getattr(want, name)
        if y is None:
            assert x is None, name
        else:
            assert x.device == y.device and torch.equal(x, y), name


@pytest.mark.parametrize("with_shs", [False, True], ids=["no_shs", "shs"])
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_ply_decode_kernel_matches_twin(cuda, compact, with_shs):
    """The record decode (csrc/plydecode.cu) on a 300,000-row INRIA export
    with the edge rows (NaN payloads, infinities, zero and negative-w
    quaternions, quantisation ties), a block of CARD_BLOCK_ROWS at a time at its
    rows, equals its twin and the host parse bit for bit, one launch a
    block."""
    from gs2pc_torch.io import gaussians_io
    from gs2pc_torch.ops import plydecode
    from ply_decode_cases import host_planes

    n, block = 300_000, gaussians_io.CARD_BLOCK_ROWS
    recs = records(INRIA, n, seed=21, edges=True)
    layout = card_layout(recs, 3)
    raw = torch.from_numpy(recs.view(np.uint8).copy())
    on_card = raw.to(cuda)
    want = host_planes(recs, 3, with_shs, compact)
    twin = {k: torch.full(w.shape, float("nan")) for k, w in want.items() if w is not None}
    card = {k: t.to(cuda) for k, t in twin.items()}
    before = plydecode.ply_decode.launches
    for lo in range(0, n, block):
        rows = min(block, n - lo)
        cut = slice(lo * layout.stride, (lo + rows) * layout.stride)
        plydecode.ply_decode(on_card[cut], rows, lo, layout, card, compact)
        plydecode.ply_decode(raw[cut], rows, lo, layout, twin, compact)
    torch.cuda.synchronize()
    assert plydecode.ply_decode.launches == before + -(-n // block)
    for name in twin:
        assert_bits_equal(card[name].cpu().numpy(), twin[name].numpy(), name)
        assert_bits_equal(card[name].cpu().numpy(), want[name], name)


@pytest.mark.parametrize("case", ["no_shs", "compact", "shs_compact"])
def test_card_load_equals_the_host_parse(cuda, tmp_path, monkeypatch, case):
    """load_gaussians on the card decodes an INRIA export there (the edge
    rows among 100,003, the last block partial, blocks on several threads):
    every plane bit-equal to the host parse's (load_ply_gaussians), one
    decode a block, the "blocks_card" reader logged; and the device
    staging freed, the current stream after every thread's work."""
    from gs2pc_torch.io import gaussians_io
    from gs2pc_torch.ops import plydecode
    from gs2pc_torch.utils import log

    n = 100_003
    path = write_ply(tmp_path / "scene.ply", records(INRIA, n, seed=22, edges=True))
    monkeypatch.setattr(gaussians_io, "CARD_BLOCK_ROWS", 4096)
    compact, with_shs = "compact" in case, case.startswith("shs")
    lines = []
    monkeypatch.setattr(log, "info", lambda msg="": lines.append(msg))
    live = torch.cuda.memory_stats(cuda)["allocation.all.current"]
    before = plydecode.ply_decode.launches
    got = gaussians_io.load_gaussians(path, compact_colours=compact, with_shs=with_shs,
                                      device=cuda)
    # The planes and the keep mask are all the load leaves allocated.
    assert torch.cuda.memory_stats(cuda)["allocation.all.current"] - live == 6 + with_shs
    blocks = -(-n // 4096)
    assert plydecode.ply_decode.launches == before + blocks
    assert lines == [f"[gs2pc_torch] ply parse: blocks_card reader, {blocks} blocks, "
                     f"f_rest {'copied' if with_shs else 'skipped'}"]
    want = gaussians_io.load_ply_gaussians(path, with_shs=with_shs, compact_colours=compact)
    for name, w in zip(("xyz", "log_scales", "rots", "colours", "opacities", "shs"), want):
        x = getattr(got, name)
        if not with_shs and name == "shs":
            assert x is None
            continue
        assert_bits_equal(x.cpu().numpy(), w, name)


def test_conversion_with_card_decode_writes_the_host_paths_ply(cuda, tmp_path, monkeypatch):
    """A conversion of an SH export through cli.main, its records decoded on
    the card, writes the PLY the host parse's conversion writes, byte for
    byte."""
    from gs2pc_torch import cli
    from gs2pc_torch.io import gaussians_io
    from gs2pc_torch.ops import plydecode

    a = capture.make_scene_arrays(40_000, seed=4)
    transforms, intr = capture.make_poses(3, 128, 96)
    ply, tj, _ = capture.write_capture(str(tmp_path), a, transforms, intr, with_masks=False)
    _write_sh_ply(ply, a)

    def convert(out):
        cli.main(["--input_path", ply, "--transform_path", tj, "--output_path", out,
                  "--num_points", "30000", "--seed", "0", "--quiet", "--num_devices", "1"])
        return open(out, "rb").read()

    before = plydecode.ply_decode.launches
    blocks = -(-40_000 // gaussians_io.CARD_BLOCK_ROWS)
    card = convert(str(tmp_path / "card.ply"))
    assert plydecode.ply_decode.launches == before + blocks
    monkeypatch.setattr(gaussians_io, "_card_layout", lambda *args: None)
    host = convert(str(tmp_path / "host.ply"))
    assert plydecode.ply_decode.launches == before + blocks
    assert len(card) > 1000 and card == host


def _write_sh_ply(path, a):
    """``a`` as a degree-3 SH .ply (f_dc from the colours, seeded f_rest)."""
    n = a.xyz.shape[0]
    f_dc = ((a.colours - 0.5) / 0.28209479177387814).astype(np.float32)
    f_rest = np.random.default_rng(16).normal(0, 0.02, (n, 45)).astype(np.float32)
    op = np.clip(a.opacities, 1e-6, 1 - 1e-6)
    props = (["x", "y", "z"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(45)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    rows = np.concatenate([a.xyz, f_dc, f_rest, np.log(op / (1 - op))[:, None],
                           a.log_scales, a.rots], axis=1).astype("<f4")
    with open(path, "wb") as fh:
        fh.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
                  + "".join(f"property float {p}\n" for p in props)
                  + "end_header\n").encode("ascii"))
        fh.write(rows.tobytes())


def _k6_twin(means, factors, opac, alive, colours, cam, cfg, adaptive):
    prep = PJ.preprocess_torch(means, factors, opac, alive, cam, adaptive)
    return prep, R.pack_blend_table(prep, colours, compact=cfg.compact)


@pytest.mark.parametrize("case", K6_CASES + ("nonfinite",))
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "full_rect"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "wide"])
def test_k6_matches_twin_bit_for_bit(cuda, case, adaptive, compact):
    """K6 with and without its table against preprocess_torch +
    pack_blend_table run on the card: every output field bit for bit (NaNs
    and signed zeros included), one launch a call."""
    means, factors, opac, alive, colours, cam, batch = frontend_inputs(case, cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, compact=compact)
    before = (PJ.project_and_pack.launches, PJ.preprocess.launches)
    got = PJ.project_and_pack(means, factors, opac, alive, colours, cam, cfg, adaptive)
    alone = PJ.preprocess(means, factors, opac, alive, cam, adaptive)
    assert (PJ.project_and_pack.launches, PJ.preprocess.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    twin = _k6_twin(means, factors, opac, alive, colours, cam, cfg, adaptive)
    torch.cuda.synchronize()
    assert got[0].valid.dtype == torch.bool and got[0].rect_min.dtype == torch.int32
    assert bits_differ(got, twin) == []
    assert bits_differ((alone, None), (twin[0], None)) == []


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "full_rect"])
def test_k6_matches_twin_on_the_capture_scene(cuda, adaptive):
    """At 200k Gaussians of the capture scene, a 1280x720 camera, compact."""
    a = capture.make_scene_arrays(200_000)
    g = Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours, a.opacities, device=cuda)
    transforms, intr = capture.make_poses(1, 1280, 720)
    batch = build_camera_batch(transforms, intr, device=cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, compact=True)
    args = (g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, g.colours, batch.at(0),
            cfg, adaptive)
    got = PJ.project_and_pack(*args)
    twin = _k6_twin(*args)
    torch.cuda.synchronize()
    assert int(got[0].valid.sum()) > 1000
    assert bits_differ(got, twin) == []


def test_k6_without_gaussians(cuda):
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("scene", cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, compact=True)
    prep, table = PJ.project_and_pack(means[:0], factors[:0], opac[:0], alive[:0],
                                      colours[:0], cam, cfg)
    torch.cuda.synchronize()
    assert table.shape == (0, 8) and prep.xy.shape == (0, 2) and prep.valid.shape == (0,)


def test_render_tile_camera_launches_k6_once(cuda):
    """A render on the card launches K6 once (with its table) and never runs
    the twin."""
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("edge", cuda)
    cfg = R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad, compact=True)
    before = (PJ.project_and_pack.launches, PJ.preprocess.launches, PJ.preprocess_torch.calls)
    R.render_tile_camera(means, factors, opac, colours, alive, cam, cfg)
    after = (PJ.project_and_pack.launches, PJ.preprocess.launches, PJ.preprocess_torch.calls)
    assert after == (before[0] + 1, before[1], before[2])
