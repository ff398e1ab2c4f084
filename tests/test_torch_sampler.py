"""gs2pc_torch's point sampler against the JAX sampler: quotas in both
distribute modes, positions under JAX's own random draws, and the
torch.Generator path checked statistically."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc.ops.sampler import distribute_points as jax_distribute
from gs2pc.ops.sampler import sample_points as jax_sample
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops.sampler import chi3_truncated_radius, distribute_points, sample_points
from tests.conftest import make_synthetic_scene

torch.set_num_threads(1)

TOL_POS = 1e-5  # positions: same draws, float32 erf/exp in two libraries


@pytest.fixture(scope="module")
def scenes():
    js = make_synthetic_scene(400, seed=21, spread=1.0, scale_lo=-4.0, scale_hi=-2.0)
    return js, Gaussians.from_jax_fields(js, device="cpu")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("num_points", [3000, 150])
def test_quotas_match_jax(exact, num_points):
    r = np.random.default_rng(5)
    sizes = r.lognormal(0.0, 1.0, 2000).astype(np.float32)
    mask = r.uniform(size=2000) > 0.2
    jq = np.asarray(
        jax_distribute(jnp.asarray(sizes), num_points, mask=jnp.asarray(mask), exact=exact)
    )
    tq = distribute_points(torch.tensor(sizes), num_points, mask=torch.tensor(mask), exact=exact)
    np.testing.assert_array_equal(jq, tq.numpy())
    if exact:
        assert int(tq.sum()) == num_points
    assert int(tq[~torch.tensor(mask)].sum()) == 0


@pytest.mark.parametrize("std", [2.0, 1e6])
def test_positions_match_jax_draws(scenes, std):
    js, ts = scenes
    ppg = np.random.default_rng(2).integers(0, 9, 400).astype(np.int32)
    n_cap = int(ppg.sum()) + 64
    key = jax.random.PRNGKey(11)
    out = jax_sample(key, js, jnp.asarray(ppg), n_cap=n_cap, mahalanobis_std=std)
    # sample_points' own draws: split the key, normals then uniforms.
    kz, ku = jax.random.split(key)
    zn = np.asarray(jax.random.normal(kz, (n_cap, 3), dtype=jnp.float32))
    u = np.asarray(jax.random.uniform(ku, (n_cap,), dtype=jnp.float32))
    got = sample_points(ts, torch.tensor(ppg), n_cap=n_cap, mahalanobis_std=std,
                        draws=(torch.tensor(zn), torch.tensor(u)))
    total = int(ppg.sum())
    assert got.points.shape == (total, 3)
    np.testing.assert_array_equal(np.asarray(out.gaussian_idx)[:total], got.gaussian_idx.numpy())
    np.testing.assert_allclose(np.asarray(out.points)[:total], got.points.numpy(), atol=TOL_POS)


def _mahalanobis(ts, pts, gid):
    R = ts.rotation_matrices()[gid]
    local = torch.einsum("nji,nj->ni", R.double(), (pts - ts.xyz[gid]).double())
    return (local / torch.exp(ts.log_scales[gid]).double()).norm(dim=1)


def test_generator_path_statistics(scenes):
    _, ts = scenes
    ppg = torch.tensor(np.random.default_rng(4).integers(0, 60, 400), dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    got = sample_points(ts, ppg, n_cap=int(ppg.sum()), mahalanobis_std=2.0, generator=gen)
    # Exact quotas, slot-major, centre first.
    np.testing.assert_array_equal(np.bincount(got.gaussian_idx.numpy(), minlength=400), ppg.numpy())
    z = _mahalanobis(ts, got.points, got.gaussian_idx)
    assert float(z.max()) <= 2.0 + 1e-4
    first = (torch.cumsum(ppg.long(), 0) - ppg)[ppg > 0]
    assert float(z[first].max()) < 1e-4
    # Radius CDF of the truncated chi_3: share of |z| < 1 among non-centres.
    rest = torch.ones_like(z, dtype=torch.bool)
    rest[first] = False
    share = float((z[rest] < 1.0).double().mean())

    def cdf(r):
        return math.erf(r / math.sqrt(2)) - math.sqrt(2 / math.pi) * r * math.exp(-r * r / 2)

    p = cdf(1.0) / cdf(2.0)
    sigma = math.sqrt(p * (1 - p) / int(rest.sum()))
    assert abs(share - p) < 5 * sigma
    # Same seed, same points.
    again = sample_points(ts, ppg, n_cap=int(ppg.sum()), mahalanobis_std=2.0,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.points, got.points)


def test_truncated_radius_stays_inside():
    u = torch.linspace(0.0, 1.0, 1001)
    for std in (0.5, 2.0, 1e8):
        r = chi3_truncated_radius(u, std)
        assert float(r.max()) <= min(std, 16.0)
        assert bool((r[1:] >= r[:-1]).all())
