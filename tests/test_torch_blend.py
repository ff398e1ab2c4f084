"""gs2pc_torch's render_tile_camera (K1's twin on CPU) against the JAX
tile renderer, through both its Pallas kernel (interpret mode) and its
XLA blend, on tests/test_pallas.py's scene and camera (K1 against its twin
on a card: test_torch_cuda.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.ops.rasterize import render_tile_camera as jax_render
from gs2pc_torch.camera import CameraBatch
from gs2pc_torch.ops import blend_kernel as B
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.projection import preprocess
from tests.test_pallas import _arrays
from tests.test_render import look_at_camera

torch.set_num_threads(1)

# Both sides composite with cumulative products; they differ only in
# scan order, a few ulps of the accumulated sums.
TOL_IMAGE = 1e-5
TOL_CONTRIB = 1e-6
TOL_SURF = 1e-5
TOL_BEST = 1e-5
PAIR_BUDGET = 1 << 15  # no JAX window truncation at this size


def _setup(n, seed):
    from gs2pc.camera import build_camera_batch

    c2w, intr = look_at_camera()
    jb, wp, hp = build_camera_batch({"cam0": c2w.tolist()}, {"cam0": intr})
    arrays = _arrays(n, seed=seed)
    tb = CameraBatch.from_jax_fields(jb, wp, hp, device="cpu")
    t_arrays = [torch.tensor(np.asarray(a)) for a in arrays]
    return jb.at(0), tb.at(0), wp, hp, arrays, t_arrays


def _half_mask(wp, hp):
    return np.concatenate(
        [np.zeros(hp * wp // 2, np.uint8), np.ones(hp * wp - hp * wp // 2, np.uint8)]
    )


def _compare(oj, ot):
    np.testing.assert_allclose(np.asarray(oj.image), ot.image.numpy(), atol=TOL_IMAGE)
    np.testing.assert_allclose(np.asarray(oj.depth), ot.depth.numpy(), atol=TOL_IMAGE)
    np.testing.assert_allclose(np.asarray(oj.invdepth), ot.invdepth.numpy(), atol=TOL_IMAGE)
    np.testing.assert_allclose(np.asarray(oj.contrib), ot.contrib.numpy(), atol=TOL_CONTRIB)
    np.testing.assert_allclose(
        np.asarray(oj.best_colour), ot.best_colour.numpy(), atol=TOL_BEST
    )
    sj = np.asarray(oj.surf_dist)
    st = ot.surf_dist.numpy()
    np.testing.assert_array_equal(sj < 1e30, st < 1e30)
    np.testing.assert_allclose(np.minimum(sj, 1e6), np.minimum(st, 1e6), atol=TOL_SURF)
    np.testing.assert_array_equal(np.asarray(oj.n_dropped), ot.n_dropped.numpy())


CASES = [
    # (JAX blend, compact tables, surface_compact, half mask, run cap)
    ("xla", False, False, False, 256),
    ("xla", True, True, True, 256),
    ("xla", True, True, False, 24),  # the run cap bites: counters 3-4 nonzero
    ("pallas", False, True, False, 256),
    ("pallas", True, False, True, 256),
]


@pytest.mark.parametrize("blend,compact,surface_compact,masked,run_cap", CASES)
def test_render_tile_camera_matches_jax(blend, compact, surface_compact, masked, run_cap):
    jc, tc, wp, hp, arrays, t_arrays = _setup(150, 3)
    mask = _half_mask(wp, hp) if masked else None
    jcfg = JaxTileConfig(
        width_pad=wp, height_pad=hp, pair_budget=PAIR_BUDGET, run_cap=run_cap,
        run_chunk=128, tile_batch=16, compact=compact, surface_compact=surface_compact,
    )
    oj = jax_render(
        *arrays, jc, jcfg, mask=None if mask is None else jnp.asarray(mask),
        use_pallas=blend == "pallas", pallas_interpret=True,
    )
    assert float(oj.n_dropped[1]) == 0.0  # JAX kept every window
    cfg = R.TileConfig(
        width_pad=wp, height_pad=hp, run_cap=run_cap, run_chunk=128,
        compact=compact, surface_compact=surface_compact,
    )
    if mask is not None:
        tc = dataclasses.replace(tc, mask=torch.tensor(mask))
    ot = R.render_tile_camera(*t_arrays, tc, cfg)
    if run_cap < 256:
        assert ot.n_dropped[2] > 0 and ot.n_dropped[3] > 0
    _compare(oj, ot)


def test_render_without_surface_pass_matches_jax():
    jc, tc, wp, hp, arrays, t_arrays = _setup(80, 5)
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, pair_budget=PAIR_BUDGET,
                         run_cap=256, run_chunk=64, tile_batch=16)
    oj = jax_render(*arrays, jc, jcfg, calc_surface_distance=False)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=256, run_chunk=64)
    ot = R.render_tile_camera(*t_arrays, tc, cfg, calc_surface_distance=False)
    _compare(oj, ot)
    assert (ot.surf_dist.numpy() > 1e30).all()


@pytest.mark.parametrize("blend", ["xla", "pallas"])
def test_twin_tie_rule_matches_jax_exact_path(blend):
    """Gaussian 0 lies in front of the rest with opacity 1 and a wide
    footprint, so alpha reaches its 0.99 clamp on a disk of pixels and every
    one of them ties for the max contribution (w = 0.99 exactly): JAX's
    exact path and the twin both take the lowest padded pixel."""
    from gs2pc.camera import build_camera_batch
    from gs2pc.models.gaussians import Gaussians as JaxGaussians
    from tests.conftest import make_synthetic_scene

    sc = make_synthetic_scene(150, seed=3, spread=1.0, scale_lo=-3.5, scale_hi=-1.5)
    xyz, ls = np.array(sc.xyz), np.array(sc.log_scales)
    rots, opa = np.array(sc.rots), np.array(sc.opacities) * 0.9
    xyz[0], ls[0], rots[0], opa[0] = (0.1, 0.05, -2.0), (0.0, 0.0, 0.0), (1, 0, 0, 0), 1.0
    g = JaxGaussians.create(xyz, ls, rots, np.array(sc.colours), opa)
    arrays = (g.xyz, g.covariance_factors(), g.opacities, g.colours, jnp.ones(150, bool))
    c2w, intr = look_at_camera()
    jb, wp, hp = build_camera_batch({"cam0": c2w.tolist()}, {"cam0": intr})
    tc = CameraBatch.from_jax_fields(jb, wp, hp, device="cpu").at(0)
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, pair_budget=PAIR_BUDGET, run_cap=256,
                         run_chunk=128, tile_batch=16)
    oj = jax_render(*arrays, jb.at(0), jcfg, want_best_pix=True,
                    use_pallas=blend == "pallas", pallas_interpret=True)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=256, run_chunk=128)
    ot = R.render_tile_camera(*[torch.tensor(np.asarray(a)) for a in arrays], tc, cfg,
                              want_best_pix=True)
    assert float(oj.contrib[0]) == float(ot.contrib[0]) == np.float32(0.99)
    # The tie is real: the clamp holds on many pixels of the first tiles.
    prep = preprocess(*[torch.tensor(np.asarray(a)) for a in arrays[:3]],
                      torch.ones(150, dtype=torch.bool), tc)
    ys, xs = torch.meshgrid(torch.arange(hp, dtype=torch.float32),
                            torch.arange(wp, dtype=torch.float32), indexing="ij")
    dx, dy = xs - prep.xy[0, 0], ys - prep.xy[0, 1]
    a, b, c = prep.conic[0]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    assert int((torch.exp(power) >= 0.99).sum()) > 10
    assert int(oj.best_pix[0]) == int(ot.best_pix[0])
    _compare(oj, ot)


def test_blend_wrapper_refuses_bad_inputs():
    table = torch.zeros((4, 8))
    gid = torch.zeros(0, dtype=torch.int32)
    tiles = torch.zeros(4, dtype=torch.int32)
    kw = dict(width=32, height=32, width_pad=32, height_pad=32, run_chunk=128,
              with_surface=True, surface_compact=True)
    with pytest.raises(ValueError):
        B.blend_tiles(table.double(), gid, tiles, tiles, None, **kw)
    with pytest.raises(ValueError):
        B.blend_tiles(table, gid, tiles[:3], tiles, None, **kw)
    with pytest.raises(ValueError):
        B.blend_tiles(table, gid, tiles, tiles, None, **{**kw, "run_chunk": 512})
