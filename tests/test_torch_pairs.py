"""K2 (pair expansion + key sort) against the JAX package's _build_pairs on
one preprocessed camera (the CUDA kernel against its twin: test_torch_cuda.py)."""

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
    keys, gids = R.sort_pairs(*R.duplicate_with_keys(_to_torch(prep), cfg, not surface))
    assert keys.shape[0] == n_real
    np.testing.assert_array_equal((keys >> 32).numpy(), jkeys[:n_real])
    np.testing.assert_array_equal(gids.numpy(), jgid[:n_real])
    dbits = np.asarray(prep.depth).view(np.int32)[jgid[:n_real]]
    np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), dbits)


def test_circle_cull_drops_pairs():
    prep, wp, hp = _jax_prep(150, 3, adaptive=True)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp)
    tp = _to_torch(prep)
    culled, _ = R.duplicate_with_keys(tp, cfg, circle_cull=True)
    full, _ = R.duplicate_with_keys(tp, cfg, circle_cull=False)
    assert 0 < culled.shape[0] < full.shape[0]


def test_tile_ranges_cover_sorted_runs():
    prep, wp, hp = _jax_prep(150, 3, adaptive=False)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp)
    keys, _ = R.sort_pairs(*R.duplicate_with_keys(_to_torch(prep), cfg, False))
    starts, runs = R.tile_ranges(keys, cfg.num_tiles)
    assert int(runs.sum()) == keys.shape[0]
    tiles = (keys >> 32).numpy()
    for t in range(cfg.num_tiles):
        s, r = int(starts[t]), int(runs[t])
        assert (tiles[s:s + r] == t).all()
