"""gs2pc_torch scene model, camera batch and preprocess against the JAX
package on the same seeded inputs (CPU)."""

import numpy as np
import pytest
import torch

from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.ops.projection import preprocess as jax_preprocess
from gs2pc_torch import pipeline
from gs2pc_torch.camera import CameraBatch, build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops.projection import preprocess
from tests.conftest import make_synthetic_scene
from tests.test_render import look_at_camera

torch.set_num_threads(1)

# Elementwise float32 products in the same term order as the JAX package.
RTOL = 1e-6
# Projection chains (xy, conic, depth) divide by small numbers.
RTOL_PROJ = 1e-5


def _close(a, b, rtol, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scenes():
    # scale_lo below the PSD floor (-8.06) so the clamp bites.
    js = make_synthetic_scene(300, seed=7, spread=1.5, scale_lo=-9.0, scale_hi=-1.0)
    return js, Gaussians.from_jax_fields(js, device="cpu")


class TestGaussians:
    def test_from_numpy_matches_from_jax_fields(self, scenes):
        js, ts = scenes
        tn = Gaussians.from_numpy(
            np.asarray(js.xyz), np.asarray(js.log_scales), np.asarray(js.rots),
            np.asarray(js.colours), np.asarray(js.opacities), device="cpu",
        )
        for name in ("xyz", "log_scales", "rots", "colours", "opacities", "keep_mask"):
            assert torch.equal(getattr(tn, name), getattr(ts, name)), name

    def test_covariance_factors(self, scenes):
        js, ts = scenes
        _close(js.covariance_factors(), ts.covariance_factors(), RTOL)

    def test_normals(self, scenes):
        js, ts = scenes
        _close(js.calculate_normals().normals, ts.calculate_normals().normals, RTOL)

    def test_validate_covariances(self, scenes):
        js, ts = scenes
        jv = np.asarray(js.validate_covariances().log_scales)
        tv = ts.validate_covariances().log_scales.numpy()
        assert (np.asarray(js.log_scales) < jv).any()  # the clamp fired
        np.testing.assert_array_equal(jv, tv)

    @pytest.mark.parametrize("with_contrib", [False, True])
    def test_magnitudes(self, scenes, with_contrib):
        js, ts = scenes
        c = np.random.default_rng(1).uniform(0, 2, 300).astype(np.float32)
        jm = js.magnitudes(contributions=c if with_contrib else None)
        tm = ts.magnitudes(contributions=torch.as_tensor(c) if with_contrib else None)
        _close(jm, tm, RTOL, atol=0.0)

    def test_cull_predicates(self, scenes):
        js, ts = scenes
        jg = js.apply_min_opacity(0.5).apply_bounding_box([-1.0, -1.0, -1.2], [1.1, 1.0, 1.0])
        jg = jg.cull_large_gaussians(0.2)
        tg = ts.apply_min_opacity(0.5).apply_bounding_box([-1.0, -1.0, -1.2], [1.1, 1.0, 1.0])
        tg = tg.cull_large_gaussians(0.2)
        np.testing.assert_array_equal(np.asarray(jg.keep_mask), tg.keep_mask.numpy())
        assert 0 < int(tg.keep_mask.sum()) < 300


def _poses(n=3, width=120, height=90, focal=110.0):
    transforms, intr = {}, {}
    for i in range(n):
        c2w, it = look_at_camera(angle=0.7 * i, width=width, height=height, focal=focal)
        transforms[f"c{i}"] = c2w.tolist()
        intr[f"c{i}"] = it
    return transforms, intr


class TestCameraBatch:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_jax(self, masked):
        transforms, intr = _poses()
        masks = None
        if masked:
            m = (np.random.default_rng(3).uniform(size=(90, 120)) > 0.3).astype(np.int32)
            masks = {"c1": m * 255}
        jb, wp, hp = jax_build_camera_batch(
            transforms, intr, colour_resolution=60, masks=masks
        )
        tb = build_camera_batch(
            transforms, intr, colour_resolution=60, masks=masks, device="cpu"
        )
        assert (tb.width_pad, tb.height_pad) == (wp, hp)
        for name in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy",
                     "focal_x", "focal_y"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                          getattr(tb, name).numpy(), err_msg=name)
        assert list(tb.widths) == [int(w) for w in np.asarray(jb.width)]
        assert list(tb.heights) == [int(h) for h in np.asarray(jb.height)]
        if masked:
            # A mask disables the colour-resolution rescale for its camera.
            assert tb.widths == (60, 120, 60)
            bits = np.unpackbits(np.asarray(jb.mask), axis=1)[:, : wp * hp]
            np.testing.assert_array_equal(bits, tb.mask.numpy())
            cb = CameraBatch.from_jax_fields(jb, wp, hp, device="cpu")
            assert torch.equal(cb.mask, tb.mask)
        else:
            assert tb.mask is None


class TestPreprocess:
    @pytest.mark.parametrize("adaptive", [True, False])
    def test_matches_jax(self, scenes, adaptive):
        js, ts = scenes
        transforms, intr = _poses(1, width=128, height=96)
        jb, wp, hp = jax_build_camera_batch(transforms, intr)
        jc = jb.at(0)
        tc = build_camera_batch(transforms, intr, device="cpu").at(0)
        alive = np.ones(300, bool)
        jp = jax_preprocess(
            js.xyz, js.covariance_factors(), js.opacities, alive,
            jc.viewmatrix, jc.projmatrix, jc.tanfovx, jc.tanfovy,
            jc.focal_x, jc.focal_y, jc.width, jc.height, adaptive_radius=adaptive,
        )
        tp = preprocess(
            ts.xyz, ts.covariance_factors(), ts.opacities, torch.tensor(alive), tc,
            adaptive_radius=adaptive,
        )
        valid = np.asarray(jp.valid)
        np.testing.assert_array_equal(valid, tp.valid.numpy())
        assert 20 < valid.sum() < 300
        for name in ("xy", "conic", "depth"):
            _close(getattr(jp, name), getattr(tp, name), RTOL_PROJ, atol=1e-5)
        for name in ("radius", "radius_q", "rect_min", "rect_max", "tiles_touched"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jp, name))[valid], getattr(tp, name).numpy()[valid],
                err_msg=name,
            )
        _close(np.asarray(jp.r_alpha_sq)[valid], tp.r_alpha_sq[tp.valid], RTOL_PROJ)


def test_precision_policy_pins_fp32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    pipeline.set_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
