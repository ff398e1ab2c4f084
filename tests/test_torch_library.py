"""The port's library leftovers against the JAX package on the CPU:
projection.mark_visible, binning.calculate_bin_sizes,
sampler.generate_pointcloud and mahalanobis, and the counterpart of
tests/test_mixed_resolution.py (a sweep over cameras of three sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.ops.binning import calculate_bin_sizes as jax_bin_sizes
from gs2pc.ops.projection import mark_visible as jax_mark_visible
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.ops.sampler import generate_pointcloud as jax_generate
from gs2pc.ops.sampler import mahalanobis as jax_mahalanobis
from gs2pc.parallel.sweep import render_sweep as jax_render_sweep
from gs2pc_torch.camera import CameraBatch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import prng
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.binning import calculate_bin_sizes
from gs2pc_torch.ops.projection import mark_visible
from gs2pc_torch.ops.sampler import generate_pointcloud, mahalanobis
from gs2pc_torch.sweep import (
    RenderArrays,
    init_accumulators,
    render_sweep,
    update_accumulators,
)
from tests.conftest import make_synthetic_scene
from tests.test_render import look_at_camera

torch.set_num_threads(1)

TOL_MAHALANOBIS = 1e-5  # relative: JAX solves in float32, the port in float64
TOL_ACC = 1e-5  # tests/test_mixed_resolution.py's


def test_mark_visible_matches_jax():
    r = np.random.default_rng(1)
    means = r.uniform(-6, 6, (256, 3)).astype(np.float32)
    means[:2] = [[0.0, 0.0, 0.0], [0.0, 0.0, -10.0]]  # tests/test_render.py's pair
    for angle in (0.0, 1.1, 2.9):
        c2w, intr = look_at_camera(angle=angle)
        jcams, wp, hp = jax_build_camera_batch({"c": c2w.tolist()}, {"c": intr})
        tcam = CameraBatch.from_jax_fields(jcams, wp, hp, device="cpu").at(0)
        want = np.asarray(jax_mark_visible(jnp.asarray(means), jcams.at(0).viewmatrix,
                                           jcams.at(0).projmatrix))
        got = mark_visible(torch.tensor(means), tcam.viewmatrix, tcam.projmatrix)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size


def _quotas(kind):
    r = np.random.default_rng(7)
    return {
        "poisson": r.poisson(20, 5000),
        "wide": r.integers(0, 2000, 20000),  # > 100 distinct values: bins wider than 1
        "heavy_tail": np.floor(r.pareto(1.2, 8000) * 10).astype(np.int64),
        "one_value": np.full(50, 3),
        "two_values": np.array([1, 1, 4, 4, 4]),
        "three_values": np.array([0, 1, 1, 2, 2, 2]),
        "empty": np.zeros(0, np.int64),
    }[kind]


@pytest.mark.parametrize("kind", ["poisson", "wide", "heavy_tail", "one_value", "two_values",
                                  "three_values", "empty"])
def test_calculate_bin_sizes_matches_jax(kind):
    """Equal to JAX's on each quota vector: fewer than 3 distinct values take
    the (1, 1) branch.  The ``length == 0`` branch cannot be reached (with 3
    or more values, bin_size <= values // 100 keeps length >= bin_size), so
    the boundary cases stand in for it."""
    ppg = _quotas(kind)
    assert calculate_bin_sizes(ppg) == jax_bin_sizes(ppg)
    if kind in ("one_value", "two_values", "empty"):
        assert calculate_bin_sizes(ppg) == (1, 1)


def _scenes(n=256):
    jscene = make_synthetic_scene(n, seed=9, spread=1.0, scale_lo=-3.5, scale_hi=-1.5)
    return jscene, Gaussians.from_jax_fields(jscene, device="cpu")


@pytest.mark.parametrize("exact", [False, True])
def test_generate_pointcloud_matches_jax(exact):
    jscene, tscene = _scenes()
    contrib = np.random.default_rng(2).uniform(0.1, 1.0, 256).astype(np.float32)
    n_points = 5000
    j = jax_generate(jax.random.PRNGKey(0), jscene, n_points, contributions=jnp.asarray(contrib),
                     exact_num_points=exact)
    t = generate_pointcloud(prng.PRNGKey(0), tscene, n_points, contributions=torch.tensor(contrib),
                            exact_num_points=exact)
    valid = np.asarray(j.valid)
    assert t.points.shape[0] == int(j.total) == int(valid.sum())
    if exact:
        assert t.points.shape[0] == n_points
    np.testing.assert_array_equal(
        np.bincount(t.gaussian_idx.numpy(), minlength=256),
        np.bincount(np.asarray(j.gaussian_idx)[valid], minlength=256))
    # The same key draws JAX's numbers: the same owners, positions within
    # float32 erf / exp / log1p rounding.
    np.testing.assert_array_equal(t.gaussian_idx.numpy(), np.asarray(j.gaussian_idx)[valid])
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points)[valid], atol=1e-5)
    # Every point lies in its Gaussian's ball.
    gid = t.gaussian_idx
    d = (t.points - tscene.xyz[gid]).double()
    z = torch.einsum("nji,nj->ni", tscene.rotation_matrices()[gid].double(), d)
    z = z / torch.exp(tscene.log_scales[gid]).double()
    assert float(z.norm(dim=1).max()) <= 2.0 + 1e-4


def test_mahalanobis_matches_jax():
    r = np.random.default_rng(5)
    a = r.normal(size=(256, 3, 3)).astype(np.float32)
    covs = (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    means = r.normal(size=(256, 3)).astype(np.float32)
    samples = (means + r.normal(size=(256, 3))).astype(np.float32)
    want = np.asarray(jax_mahalanobis(jnp.asarray(means), jnp.asarray(samples),
                                      jnp.asarray(covs)))
    got = mahalanobis(torch.tensor(means), torch.tensor(samples), torch.tensor(covs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_MAHALANOBIS)


def test_mixed_resolutions_match_individual_renders_and_jax():
    """tests/test_mixed_resolution.py: three cameras of other sizes padded to
    64x64; the sweep equals the per-camera renders folded in turn and JAX's
    sweep, and the 32x32 camera's padding stays empty."""
    n = 96
    scene = make_synthetic_scene(n, seed=31, spread=1.0, scale_lo=-3.5, scale_hi=-1.5)
    arrays = (scene.xyz, scene.covariance_factors(), scene.opacities, scene.colours,
              jnp.ones(n, bool))
    transforms, intr = {}, {}
    for i, (w, h, f) in enumerate([(64, 48, 70.0), (48, 64, 60.0), (32, 32, 40.0)]):
        c2w, _ = look_at_camera(angle=i * 1.3, width=w, height=h, focal=f)
        transforms[f"c{i}"] = c2w.tolist()
        intr[f"c{i}"] = (w, h, f, f)
    jcams, wp, hp = jax_build_camera_batch(transforms, intr)
    assert (wp, hp) == (64, 64)
    jacc = jax_render_sweep(arrays, jcams, JaxTileConfig(
        width_pad=wp, height_pad=hp, big_cap=n, run_cap=128, run_chunk=64))

    tscene = RenderArrays(*(torch.tensor(np.asarray(a)) for a in arrays))
    tcams = CameraBatch.from_jax_fields(jcams, wp, hp, device="cpu")
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=128, run_chunk=64)
    acc = render_sweep(tscene, tcams, cfg)
    ref = init_accumulators(n, device="cpu")
    for i in range(3):
        ref = update_accumulators(ref, R.render_tile_camera(*tscene, tcams.at(i), cfg))
    for name in ("max_contribution", "colours", "total_contribution", "min_surface_distance"):
        assert torch.equal(getattr(acc, name), getattr(ref, name)), name
    for name in ("max_contribution", "total_contribution"):
        np.testing.assert_allclose(getattr(acc, name).numpy(), np.asarray(getattr(jacc, name)),
                                   atol=TOL_ACC)

    img = R.render_tile_camera(*tscene, tcams.at(2), cfg).image.numpy()
    assert (img[32:] == 0).all() and (img[:, 32:] == 0).all()
    assert img[:32, :32].max() > 0
