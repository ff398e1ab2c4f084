"""K1's depth-slab modes (its twin, on CPU tensors) through gs2pc_torch's
render_tile_camera against the JAX tile renderer in the same mode, through
its Pallas kernel (interpret mode) and its XLA blend, on
tests/test_pallas.py's scene and camera.  The kernel against its twin in
each mode, on a card: test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.ops.rasterize import render_tile_camera as jax_render
from gs2pc.ops.blend import T_EPS
from gs2pc_torch.ops import rasterize as R
from tests.test_torch_blend import PAIR_BUDGET, _setup

torch.set_num_threads(1)

# Both sides composite with products of the same factors in another
# order: a few ulps of the accumulated sums.
TOL_IMAGE = 1e-5
TOL_CONTRIB = 1e-6
TOL_SURF = 1e-5


def _modes(wp, hp):
    """The four depth-slab modes, each as render_tile_camera keywords (the
    same names on both sides).  The starting-T map holds ~10% of pixels
    below T_EPS: they stop on their first pair and blend nothing, unless
    the stop is off (then they blend, with weights below T_EPS)."""
    r = np.random.default_rng(11)
    t0 = r.uniform(0.2, 1.0, wp * hp).astype(np.float32)
    t0[r.uniform(size=wp * hp) < 0.1] = 0.1 * T_EPS
    ed = r.uniform(3.0, 5.0, wp * hp).astype(np.float32)
    return {
        "init_trans": dict(init_trans=t0, calc_surface_distance=False, want_best_pix=True),
        "early_stop_off": dict(early_stop=False, init_trans=t0, calc_surface_distance=False,
                               want_trans=True),
        "ed_override": dict(surface_ed_override=ed, init_trans=t0, want_best_pix=True),
        "black_background": dict(white_bkgd=False, want_trans=True, want_best_pix=True),
    }


@pytest.mark.parametrize("blend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["init_trans", "early_stop_off", "ed_override",
                                  "black_background"])
def test_blend_mode_matches_jax(mode, blend):
    jc, tc, wp, hp, arrays, t_arrays = _setup(150, 3)
    kw = _modes(wp, hp)[mode]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jcfg = JaxTileConfig(width_pad=wp, height_pad=hp, pair_budget=PAIR_BUDGET, run_cap=256,
                         run_chunk=128, tile_batch=16, compact=True, surface_compact=True)
    oj = jax_render(*arrays, jc, jcfg, use_pallas=blend == "pallas", pallas_interpret=True,
                    **jkw)
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=256, run_chunk=128, compact=True,
                       surface_compact=True)
    ot = R.render_tile_camera(*t_arrays, tc, cfg, **tkw)

    for name in ("image", "depth", "invdepth"):
        np.testing.assert_allclose(getattr(ot, name).numpy(), np.asarray(getattr(oj, name)),
                                   atol=TOL_IMAGE, err_msg=name)
    if kw.get("want_trans"):
        np.testing.assert_allclose(ot.trans.numpy(), np.asarray(oj.trans), atol=TOL_IMAGE)
    contrib = np.asarray(oj.contrib)
    np.testing.assert_allclose(ot.contrib.numpy(), contrib, atol=TOL_CONTRIB)
    assert (contrib > 0).sum() > 20
    if kw.get("want_best_pix"):
        hit = contrib > 0
        np.testing.assert_array_equal(ot.best_pix.numpy()[hit], np.asarray(oj.best_pix)[hit])
    sj, st = np.asarray(oj.surf_dist), ot.surf_dist.numpy()
    np.testing.assert_array_equal(sj < 1e30, st < 1e30)
    np.testing.assert_allclose(np.minimum(st, 1e6), np.minimum(sj, 1e6), atol=TOL_SURF)
    np.testing.assert_array_equal(ot.n_dropped.numpy(), np.asarray(oj.n_dropped))

    if mode in ("init_trans", "early_stop_off"):
        # A pixel that starts below T_EPS blends nothing, unless the stop
        # is off.
        low = torch.tensor(kw["init_trans"] < T_EPS).reshape(hp, wp)
        assert low.any()
        blended = float(ot.depth[low].abs().max())
        assert blended > 0.0 if mode == "early_stop_off" else blended == 0.0
