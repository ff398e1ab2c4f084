"""K2 (pair expansion + key sort) against the JAX package's _build_pairs on
one preprocessed camera, and the card's depth-first order (depth sort, K2 in
rank order, tile sort) against the int64 key sort, through the twins of its
steps (the CUDA kernels against those twins: test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc.ops.projection import preprocess as jax_preprocess
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.ops.rasterize import _build_pairs
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.projection import Preprocessed
from tests.conftest import make_synthetic_scene
from tests.test_render import single_camera

torch.set_num_threads(1)

# Far above the scene's coverage (<= 200 Gaussians x 64 tiles) and below
# 2^20, so JAX takes its exact (tile, depth bits, gid) sort and keeps
# every rect tile: nothing is truncated.
PAIR_BUDGET = 1 << 15


def _jax_prep(n, seed, adaptive):
    scene = make_synthetic_scene(n, seed=seed, spread=1.0, scale_lo=-3.5, scale_hi=-1.5)
    cam, wp, hp = single_camera()
    prep = jax_preprocess(
        scene.xyz, scene.covariance_factors(), scene.opacities * 0.9,
        jnp.ones(n, bool), cam.viewmatrix, cam.projmatrix, cam.tanfovx, cam.tanfovy,
        cam.focal_x, cam.focal_y, cam.width, cam.height, adaptive_radius=adaptive,
    )
    return prep, wp, hp


def _to_torch(prep) -> Preprocessed:
    return Preprocessed(*(torch.tensor(np.asarray(x)) for x in prep))


@pytest.mark.parametrize("surface", [True, False], ids=["full_rect", "circle_cull"])
@pytest.mark.parametrize("n,seed", [(150, 3), (200, 8)])
def test_twin_matches_jax_build_pairs(n, seed, surface):
    prep, wp, hp = _jax_prep(n, seed, adaptive=not surface)
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, pair_budget=PAIR_BUDGET)
    jkeys, jgid, win_dropped = _build_pairs(prep, jcfg, circle_cull=not surface)
    assert int(win_dropped) == 0
    jkeys, jgid = np.asarray(jkeys), np.asarray(jgid)
    n_real = int((jkeys < jcfg.num_tiles).sum())

    cfg = R.TileConfig(width_pad=wp, height_pad=hp)
    keys, gids = R.sort_pairs(*R.duplicate_with_keys_torch(_to_torch(prep), cfg, not surface))
    assert keys.shape[0] == n_real
    np.testing.assert_array_equal((keys >> 32).numpy(), jkeys[:n_real])
    np.testing.assert_array_equal(gids.numpy(), jgid[:n_real])
    dbits = np.asarray(prep.depth).view(np.int32)[jgid[:n_real]]
    np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), dbits)


@pytest.mark.parametrize("surface", [True, False], ids=["full_rect", "circle_cull"])
@pytest.mark.parametrize("n,seed", [(150, 3), (200, 8)])
def test_twin_unsorted_order_is_gid_major_rect_row_major(n, seed, surface):
    """Before the sort the twin emits each valid Gaussian's tiles in gid
    order and, within a Gaussian, rect row-major (the circle cull only drops
    tiles): the index the pair-parallel CUDA write gives every pair."""
    prep, wp, hp = _jax_prep(n, seed, adaptive=not surface)
    tp = _to_torch(prep)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp)
    keys, gids = R.duplicate_with_keys_torch(tp, cfg, not surface)
    rmin, rmax = tp.rect_min.numpy(), tp.rect_max.numpy()
    order = [(g, ty * cfg.grid_w + tx)
             for g in np.flatnonzero(tp.valid.numpy())
             for ty in range(rmin[g, 1], rmax[g, 1])
             for tx in range(rmin[g, 0], rmax[g, 0])]
    got = list(zip(gids.tolist(), (keys >> 32).tolist()))
    if surface:
        assert got == order
    else:
        kept = set(got)
        assert [pair for pair in order if pair in kept] == got
        assert 0 < len(got) < len(order)
    dbits = tp.depth.view(torch.int32).long()[gids.long()]
    assert torch.equal(keys & 0xFFFFFFFF, dbits)


def test_circle_cull_drops_pairs():
    prep, wp, hp = _jax_prep(150, 3, adaptive=True)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp)
    tp = _to_torch(prep)
    order = R.depth_order(tp.depth, tp.valid)
    culled, _ = R.duplicate_with_keys(tp, cfg, True, order)
    full, _ = R.duplicate_with_keys(tp, cfg, False, order)
    assert 0 < culled.shape[0] < full.shape[0]


def test_tile_ranges_cover_sorted_runs():
    prep, wp, hp = _jax_prep(150, 3, adaptive=False)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp)
    tile_ids, _ = R.order_pairs(_to_torch(prep), cfg, False)
    starts, runs = R.tile_ranges(tile_ids, cfg.num_tiles)
    assert int(runs.sum()) == tile_ids.shape[0]
    tiles = tile_ids.numpy()
    for t in range(cfg.num_tiles):
        s, r = int(starts[t]), int(runs[t])
        assert (tiles[s:s + r] == t).all()


def _drawn_prep(n, seed, grid_w, grid_h, depths=None, valid_share=0.8) -> Preprocessed:
    """A camera's preprocess drawn directly: rects of 1-4 tiles a side on a
    grid_w x grid_h grid, centres inside them, radii that the circle cull
    trims, depths uniform in [1, 9] or drawn from ``depths`` (exact ties);
    invalid Gaussians keep garbage rects and negative depths."""
    r = np.random.default_rng(seed)
    rmin = np.stack([r.integers(0, grid_w - 3, n), r.integers(0, grid_h - 3, n)], 1)
    rmax = rmin + r.integers(1, 5, (n, 2))
    rmax = np.minimum(rmax, [grid_w, grid_h])
    xy = (rmin + r.uniform(0, 1, (n, 2)) * (rmax - rmin)) * 16.0
    depth = r.uniform(1, 9, n) if depths is None else r.choice(depths, n)
    valid = r.uniform(size=n) < valid_share
    rmin[~valid] = r.integers(-50, 50, (int((~valid).sum()), 2))
    depth[~valid] = -depth[~valid]

    def t(a, dt):
        return torch.tensor(np.asarray(a), dtype=dt)

    return Preprocessed(
        depth=t(depth, torch.float32), xy=t(xy, torch.float32),
        conic=t(np.zeros((n, 3)), torch.float32), opacity=t(np.ones(n), torch.float32),
        radius=t(np.ones(n), torch.float32),
        r_alpha_sq=t(r.uniform(4.0, 40.0, n) ** 2, torch.float32),
        radius_q=t(np.ones(n), torch.float32), rect_min=t(rmin, torch.int32),
        rect_max=t(rmax, torch.int32), tiles_touched=t((rmax - rmin).prod(1) * valid, torch.int32),
        valid=t(valid, torch.bool))


def _depth_first_case(case, surface):
    """(Preprocessed, TileConfig) of a case of the depth-first order test."""
    if case.startswith("jax"):
        _, n, seed = case.split("-")
        prep, wp, hp = _jax_prep(int(n), int(seed), adaptive=not surface)
        return _to_torch(prep), R.TileConfig(width_pad=wp, height_pad=hp)
    grid = {"wide_grid": (40, 30)}.get(case, (12, 10))
    prep = _drawn_prep(
        3000 if case == "wide_grid" else 800, 5, *grid,
        depths=[2.0, 2.5, 3.0] if case == "depth_ties" else None,
        valid_share=0.0 if case == "no_valid" else 0.8)
    return prep, R.TileConfig(width_pad=16 * grid[0], height_pad=16 * grid[1])


@pytest.mark.parametrize("surface", [True, False], ids=["full_rect", "circle_cull"])
@pytest.mark.parametrize("case", ["jax-150-3", "jax-200-8", "depth_ties", "wide_grid",
                                  "no_valid"])
def test_depth_first_order_matches_int64_key_sort(case, surface):
    """The card's order, built from the twins of its steps: a stable sort of
    the Gaussians by depth bits (the invalid ones last), the twin's pairs
    moved to that rank order
    (what K2 writes), then a stable sort by tile id alone.  Its gids, tile
    starts and runs equal those of the int64 (tile << 32 | depth bits) key
    sort of the twin's gid-order pairs: exact depth ties fall to gid order, a
    grid of more than 256 tiles takes two radix digits, and a camera with no
    valid Gaussian has no pair."""
    tp, cfg = _depth_first_case(case, surface)
    keys, gids = R.sort_pairs(*R.duplicate_with_keys_torch(tp, cfg, not surface))

    order = R.depth_order(tp.depth, tp.valid)
    assert sorted(order.tolist()) == list(range(tp.xy.shape[0]))
    ranked_valid = tp.valid[order.long()]
    assert torch.equal(ranked_valid, torch.sort(ranked_valid.int(), descending=True)[0].bool())
    tiles, ranked = R.duplicate_with_keys(tp, cfg, not surface, order)
    assert tiles.dtype == ranked.dtype == torch.int32
    sorted_tile, sorted_gid = R.sort_by_tile(tiles, ranked, cfg.num_tiles)

    assert torch.equal(sorted_gid, gids)
    assert torch.equal(sorted_tile.long(), keys >> 32)
    for got, want in zip(R.tile_ranges(sorted_tile, cfg.num_tiles),
                         R.tile_ranges((keys >> 32).to(torch.int32), cfg.num_tiles)):
        assert torch.equal(got, want)
    # The entry point K1's inputs come from: the int64 key sort on the CPU.
    cpu_tile, cpu_gid = R.order_pairs(tp, cfg, not surface)
    assert torch.equal(cpu_tile, sorted_tile) and torch.equal(cpu_gid, sorted_gid)
    if case == "no_valid":
        assert gids.numel() == 0
    else:
        assert gids.numel() > 0
    if case == "wide_grid":
        assert cfg.num_tiles > 256 and R.tile_bits(cfg.num_tiles) > 8
        assert int(sorted_tile.max()) >= 256
    if case == "depth_ties":
        d = tp.depth[sorted_gid.long()]
        same = (sorted_tile[1:] == sorted_tile[:-1]) & (d[1:] == d[:-1])
        assert int(same.sum()) > 100  # ties that gid order decides
        assert bool((sorted_gid[1:][same] > sorted_gid[:-1][same]).all())
