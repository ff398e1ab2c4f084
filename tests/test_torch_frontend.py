"""The per-camera front end, K6's wrappers (gs2pc_torch.ops.projection.
preprocess / project_and_pack), on CPU tensors: equal to their plain twin
(preprocess_torch + rasterize.pack_blend_table) bit for bit, and to the JAX
package's preprocess + pack_blend_table on the same seeded inputs.  K6
itself against the twin on the card: test_torch_cuda.py."""

import re

import numpy as np
import pytest
import torch

from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.ops.projection import preprocess as jax_preprocess
from gs2pc.ops.rasterize import pack_blend_table as jax_pack_blend_table
from gs2pc_torch.ops import cuda_build
from gs2pc_torch.ops import projection as PJ
from gs2pc_torch.ops import rasterize as R
from tests.frontend_cases import (
    CASES,
    bits_differ,
    camera_inputs,
    frontend_inputs,
)

torch.set_num_threads(1)

# The projection chain divides by small numbers; the two packages round
# the same float32 operations in another order in places (XLA's fusion).
RTOL = 1e-5
ATOL = 1e-5

MODES = [pytest.param(a, c, id=f"{'adaptive' if a else 'full_rect'}-"
                               f"{'compact' if c else 'wide'}")
         for a in (True, False) for c in (True, False)]


def _cfg(batch, compact: bool):
    return R.TileConfig(width_pad=batch.width_pad, height_pad=batch.height_pad,
                        compact=compact)


def _twin(inputs, compact: bool, adaptive: bool):
    means, factors, opac, alive, colours, cam, _ = inputs
    prep = PJ.preprocess_torch(means, factors, opac, alive, cam, adaptive)
    return prep, R.pack_blend_table(prep, colours, compact=compact)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("adaptive,compact", MODES)
def test_project_and_pack_equals_twin(case, adaptive, compact):
    inputs = frontend_inputs(case, "cpu")
    means, factors, opac, alive, colours, cam, batch = inputs
    got = PJ.project_and_pack(means, factors, opac, alive, colours, cam,
                              _cfg(batch, compact), adaptive_radius=adaptive)
    assert got[1].shape == (means.shape[0], 8 if compact else 16)
    assert bits_differ(got, _twin(inputs, compact, adaptive)) == []
    assert bits_differ((PJ.preprocess(means, factors, opac, alive, cam, adaptive), None),
                       (got[0], None)) == []


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("adaptive,compact", MODES)
def test_project_and_pack_matches_jax(case, adaptive, compact):
    means, factors, opac, alive, colours, cam, batch = frontend_inputs(case, "cpu")
    prep, table = PJ.project_and_pack(means, factors, opac, alive, colours, cam,
                                      _cfg(batch, compact), adaptive_radius=adaptive)
    transforms, intr = camera_inputs(case)
    jc = jax_build_camera_batch(transforms, intr)[0].at(0)
    jp = jax_preprocess(
        means.numpy(), factors.numpy(), opac.numpy(), alive.numpy(),
        jc.viewmatrix, jc.projmatrix, jc.tanfovx, jc.tanfovy, jc.focal_x, jc.focal_y,
        jc.width, jc.height, adaptive_radius=adaptive,
    )
    jt = np.asarray(jax_pack_blend_table(jp, colours.numpy(), compact=compact))
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(valid, prep.valid.numpy())
    assert 10 < valid.sum() < means.shape[0]
    for name in ("xy", "conic", "depth", "r_alpha_sq"):
        np.testing.assert_allclose(prep._asdict()[name].numpy()[valid],
                                   np.asarray(getattr(jp, name))[valid],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(prep.depth.numpy(), np.asarray(jp.depth), rtol=RTOL, atol=ATOL)
    for name in ("radius", "radius_q", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(prep._asdict()[name].numpy()[valid],
                                      np.asarray(getattr(jp, name))[valid], err_msg=name)
    t = table.numpy()[valid]
    np.testing.assert_allclose(t[:, :7], jt[valid][:, :7], rtol=RTOL, atol=ATOL)
    # The rgb24 lane (compact) or the colour lanes (wide) exactly.
    np.testing.assert_array_equal(t[:, 7:], jt[valid][:, 7:])


def test_nonfinite_means_get_clamped_rects_and_no_validity():
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("nonfinite", "cpu")
    cfg = _cfg(batch, True)
    prep, table = PJ.project_and_pack(means, factors, opac, alive, colours, cam, cfg,
                                      adaptive_radius=False)
    assert not prep.valid[:5].any()
    hi = torch.tensor([cfg.grid_w, cfg.grid_h], dtype=torch.int32)
    for rect in (prep.rect_min, prep.rect_max):
        assert rect.dtype == torch.int32
        assert bool(((rect >= 0) & (rect <= hi)).all())
    assert bool((prep.tiles_touched[prep.valid] > 0).all())
    assert bits_differ((prep, table), _twin(
        (means, factors, opac, alive, colours, cam, batch), True, False)) == []


def test_cpu_wrappers_run_the_twin_and_launch_nothing():
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("scene", "cpu")
    before = (PJ.preprocess_torch.calls, PJ.preprocess.launches, PJ.project_and_pack.launches)
    PJ.preprocess(means, factors, opac, alive, cam)
    PJ.project_and_pack(means, factors, opac, alive, colours, cam, _cfg(batch, True))
    after = (PJ.preprocess_torch.calls, PJ.preprocess.launches, PJ.project_and_pack.launches)
    assert after == (before[0] + 2, before[1], before[2])


def test_wrappers_refuse_other_devices():
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("scene", "cpu")
    meta = [t.to("meta") for t in (means, factors, opac, alive, colours)]
    with pytest.raises(ValueError, match="unsupported device"):
        PJ.preprocess(*meta[:4], cam)
    with pytest.raises(ValueError, match="unsupported device"):
        PJ.project_and_pack(*meta, cam, _cfg(batch, True))


def test_render_tile_camera_packs_through_project_and_pack(monkeypatch):
    """One project_and_pack a render; blend_inputs takes its table and packs
    no second one (the one pack is the twin's, inside project_and_pack);
    the render equals one from a table packed by blend_inputs."""
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("scene", "cpu")
    cfg = _cfg(batch, True)
    calls = []
    real_pack = R.pack_blend_table

    def counted(*a, **k):
        calls.append("project_and_pack")
        return PJ.project_and_pack(*a, **k)

    def pack(*a, **k):
        calls.append("pack_blend_table")
        return real_pack(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(R, "project_and_pack", counted)
        m.setattr(R, "pack_blend_table", pack)
        out = R.render_tile_camera(means, factors, opac, colours, alive, cam, cfg)
    assert calls == ["project_and_pack", "pack_blend_table"]
    prep = PJ.preprocess_torch(means, factors, opac, alive, cam, adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, colours, cam, cfg, calc_surface_distance=True)
    ref = R.blend_tiles(*args, **kw)
    assert torch.equal(out.image, ref.image)
    assert torch.equal(out.contrib, ref.contrib)
    assert torch.equal(out.surf_dist, ref.surf_dist)


def test_blend_inputs_takes_a_packed_table():
    means, factors, opac, alive, colours, cam, batch = frontend_inputs("edge", "cpu")
    cfg = _cfg(batch, False)
    prep, table = PJ.project_and_pack(means, factors, opac, alive, colours, cam, cfg)
    given, _, runs = R.blend_inputs(prep, colours, cam, cfg, False, table=table)
    packed, _, runs2 = R.blend_inputs(prep, colours, cam, cfg, False)
    assert given[0] is table
    assert torch.equal(packed[0], table)
    assert torch.equal(runs, runs2)


def test_pinned_cov_sums_equal_the_reduction_on_cpu():
    """The twin's written-out (v0 + v1) + v2 changes no bit of the CPU's
    .sum(-1), so the CPU results (and their parity with JAX) are those of
    the reduction."""
    r = np.random.default_rng(3)
    for n in (5, 256, 4099):
        v = torch.tensor(r.normal(size=(n, 3)) * r.uniform(0, 100, (n, 1)), dtype=torch.float32)
        assert torch.equal(PJ._sum3(v), v.sum(-1))


def test_k6_binding_matches_the_entry_point():
    """cuda_build's ctypes signature of gs2pc_project_pack has the C entry
    point's parameters, pointer for pointer and int for int (no compiler
    here to check the call)."""
    with open(cuda_build.os.path.join(cuda_build._CSRC, "project.cu")) as fh:
        src = fh.read()
    params = re.search(r"GS2PC_API int gs2pc_project_pack\(([^)]*)\)", src).group(1)
    kinds = ["p" if "*" in p else "i" for p in params.split(",")]
    restype, argtypes = cuda_build._SIGNATURES["gs2pc_project_pack"]
    assert restype is cuda_build._I
    assert kinds == ["p" if a is cuda_build._P else "i" for a in argtypes]
    assert all(a in (cuda_build._P, cuda_build._I) for a in argtypes)
