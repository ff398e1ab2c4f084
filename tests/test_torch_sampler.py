"""gs2pc_torch's point sampler against the JAX sampler: quotas in both
distribute modes, positions under injected draws and under the same key
(the port draws JAX's numbers, gs2pc_torch.ops.prng), blocks of slots
against the whole range, and the keyed draws checked statistically."""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc.ops.sampler import distribute_points as jax_distribute
from gs2pc.ops.sampler import sample_points as jax_sample
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import prng
from gs2pc_torch.ops.sampler import (
    _chi3_cdf,
    chi3_radius_by_table,
    chi3_table,
    chi3_truncated_radius,
    distribute_points,
    sample_points,
    slot_prefix,
)
from gs2pc_torch.parallel.mesh import split_evenly
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
    got = sample_points(prng.PRNGKey(11), ts, torch.tensor(ppg), n_cap=n_cap,
                        mahalanobis_std=std, draws=(torch.tensor(zn), torch.tensor(u)))
    total = int(ppg.sum())
    assert got.points.shape == (total, 3)
    np.testing.assert_array_equal(np.asarray(out.gaussian_idx)[:total], got.gaussian_idx.numpy())
    np.testing.assert_allclose(np.asarray(out.points)[:total], got.points.numpy(), atol=TOL_POS)


@pytest.mark.parametrize("std", [2.0, 1e6])
def test_sample_points_matches_jax_key(scenes, std):
    """No injected draws: the same key gives JAX's owners exactly and its
    positions within TOL_POS (the normals differ by a few float32 ulps,
    XLA's log1p against torch's)."""
    js, ts = scenes
    ppg = np.random.default_rng(3).integers(0, 9, 400).astype(np.int32)
    ppg[::7] = 0
    n_cap = int(ppg.sum()) + 64
    out = jax_sample(jax.random.PRNGKey(5), js, jnp.asarray(ppg), n_cap=n_cap, mahalanobis_std=std)
    got = sample_points(prng.PRNGKey(5), ts, torch.tensor(ppg), n_cap=n_cap, mahalanobis_std=std)
    total = int(ppg.sum())
    assert got.points.shape == (total, 3)
    np.testing.assert_array_equal(np.asarray(out.gaussian_idx)[:total], got.gaussian_idx.numpy())
    np.testing.assert_allclose(np.asarray(out.points)[:total], got.points.numpy(), atol=TOL_POS)


@pytest.mark.parametrize("parts", [2, 3, 7])
def test_blocks_concatenate_to_the_whole(scenes, parts):
    """Blocks of slots (the SPMD conversion's split) concatenated in order
    equal the whole range bit for bit, the cut at n_cap included."""
    _, ts = scenes
    ppg = torch.tensor(np.random.default_rng(6).integers(0, 12, 400), dtype=torch.int32)
    n_cap = int(ppg.sum()) - 37
    key = prng.PRNGKey(9)
    whole = sample_points(key, ts, ppg, n_cap=n_cap)
    _, n = slot_prefix(ppg, n_cap)
    assert whole.points.shape[0] == n == n_cap
    blocks = [sample_points(key, ts, ppg, n_cap=n_cap, block=b) for b in split_evenly(n, parts)]
    assert torch.equal(torch.cat([b.points for b in blocks]), whole.points)
    assert torch.equal(torch.cat([b.gaussian_idx for b in blocks]), whole.gaussian_idx)


def _mahalanobis(ts, pts, gid):
    R = ts.rotation_matrices()[gid]
    local = torch.einsum("nji,nj->ni", R.double(), (pts - ts.xyz[gid]).double())
    return (local / torch.exp(ts.log_scales[gid]).double()).norm(dim=1)


def test_generator_path_statistics(scenes):
    _, ts = scenes
    ppg = torch.tensor(np.random.default_rng(4).integers(0, 60, 400), dtype=torch.int32)
    got = sample_points(prng.PRNGKey(3), ts, ppg, n_cap=int(ppg.sum()), mahalanobis_std=2.0)
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
    again = sample_points(prng.PRNGKey(3), ts, ppg, n_cap=int(ppg.sum()), mahalanobis_std=2.0)
    assert torch.equal(again.points, got.points)


def test_truncated_radius_stays_inside():
    u = torch.linspace(0.0, 1.0, 1001)
    for std in (0.5, 2.0, 1e8):
        r = chi3_truncated_radius(u, std)
        assert float(r.max()) <= min(std, 16.0)
        assert bool((r[1:] >= r[:-1]).all())


def _below_one() -> float:
    return float(np.nextafter(np.float32(1.0), np.float32(0.0)))


@pytest.mark.parametrize("levels", [1, 10, 12])
@pytest.mark.parametrize("std", [0.5, 2.0, 16.0, 1e6])
def test_table_walk_matches_bisection(std, levels):
    """K5's threshold-table walk (its plain twin) gives the bisection's
    radius bit for bit: every decision compares the same two floats."""
    u = torch.tensor(np.random.default_rng(12).uniform(size=100_000), dtype=torch.float32)
    u[0], u[1] = 0.0, _below_one()
    assert torch.equal(chi3_radius_by_table(u, std, levels), chi3_truncated_radius(u, std))


def test_table_nodes_are_the_bisections_thresholds():
    """Node n of chi3_table holds chi3_cdf at the midpoint that the
    decisions in n's bits reach."""
    std, levels = 2.0, 6
    table = chi3_table(std, levels)
    for node in (1, 2, 3, 5, 22, 63):
        lo, hi = torch.tensor(0.0), torch.tensor(min(std, 16.0))
        for d in range(node.bit_length() - 2, -1, -1):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if (node >> d) & 1 else (lo, mid)
        assert torch.equal(table[node], _chi3_cdf(0.5 * (lo + hi)))


@pytest.mark.parametrize("seed", [0, 1, 2**31, 2**32 - 1])
def test_split_words_match_split(seed):
    """The wrapper's key split in Python integers equals prng.split."""
    key = prng.PRNGKey(seed)
    assert [list(w) for w in prng.split_words(key)] == prng.split(key).tolist()


@pytest.mark.parametrize("max_points,n_cap,want", [
    (None, 10**9, 41), (30, 10**9, 30), (None, 17, 17), (50, 45, 41)])
def test_slot_prefix_counts_the_slots(max_points, n_cap, want):
    ppg = torch.tensor([3, 0, 0, 7, 1, 0, 30], dtype=torch.int32)
    prefix, n = slot_prefix(ppg, n_cap, max_points)
    assert prefix.dtype == torch.int64 and prefix.tolist() == [3, 3, 3, 10, 11, 11, 41]
    assert n == want
    assert slot_prefix(torch.zeros(0, dtype=torch.int32), 5)[1] == 0


def _k5_constants() -> dict:
    """K5's numeric #defines, read from csrc/sampler.cu (a name defined as
    another takes its value)."""
    src = os.path.join(os.path.dirname(__file__), "..", "gs2pc_torch", "csrc", "sampler.cu")
    with open(src) as fh:
        defs = dict(re.findall(r"^#define (K5_\w+) (\w+)", fh.read(), re.M))
    return {k: int(defs.get(v, v)) for k, v in defs.items() if defs.get(v, v).isdigit()}


def _first_owner(prefix: np.ndarray, s: int) -> int:
    """K5's 32-way warp search, lane by lane."""
    a, b = 0, len(prefix) - 1
    while a < b:
        idx = [a + (((b - a) * (lane + 1)) >> 5) for lane in range(32)]
        f = next(lane for lane in range(32) if lane == 31 or prefix[idx[lane]] > s)
        a, b = (idx[f - 1] + 1 if f > 0 else a), idx[f]
    return a


def _tile_owners(prefix: np.ndarray, s0: int, length: int, window: int, threads: int):
    """K5's owners, centres and compacted draw order of one tile: the
    tile's first owner g0, the window of exclusive prefixes after it less
    s0 (clamped to int32), each slot's halving search there for the last
    entry at or below it (or a search of the whole prefix past the
    window), then the slots that draw in the order of the per-(round,
    warp) scan."""
    g0 = _first_owner(prefix, s0)
    excl = [0 if g < 0 else (int(prefix[g]) if g < len(prefix) else 2**63 - 1)
            for g in range(g0 - 1, g0 + window)]
    rel = [max(-1, min(e - s0, 2**31 - 1)) for e in excl]
    owners, centres = [], []
    for k in range(length):
        if rel[window] > k:
            pos, step = 0, window // 2
            while step:
                if rel[pos + step] <= k:
                    pos += step
                step //= 2
            g, centre = g0 + pos, rel[pos] == k
        else:
            s = s0 + k
            g = int(np.searchsorted(prefix[g0 + window:], s, side="right")) + g0 + window
            centre = s == prefix[g - 1]
        owners.append(g)
        centres.append(centre)
    rounds, warps = window // threads, threads // 32
    order = [r * threads + w * 32 + lane for r in range(rounds) for w in range(warps)
             for lane in range(32)]
    draws = [k for k in order if k < length and not centres[k]]
    return owners, centres, draws


@pytest.mark.parametrize("quotas", ["random", "long_run", "zero_gaps", "all_ones"])
def test_k5_tile_owners_replay(quotas):
    """A replay of K5's per-tile owner search and compaction (its constants
    read from csrc/sampler.cu) against the twin's searchsorted: the same
    owners and centres, and the drawing slots listed in slot order."""
    k5 = _k5_constants()
    tile, threads, window = k5["K5_TILE"], k5["K5_THREADS"], k5["K5_WINDOW"]
    r = np.random.default_rng(14)
    ppg = {"random": lambda: r.integers(0, 7, 3000),
           "long_run": lambda: np.r_[r.integers(0, 7, 100), 5 * tile, r.integers(0, 7, 100)],
           "zero_gaps": lambda: np.where(np.arange(6000) % (window + 300) == 5, 3, 0),
           "all_ones": lambda: np.ones(2500, dtype=np.int64)}[quotas]()
    prefix = np.cumsum(ppg).astype(np.int64)
    n = int(prefix[-1])
    gid = np.searchsorted(prefix, np.arange(n), side="right")
    centre = np.arange(n) == prefix[gid] - ppg[gid]
    for s0 in sorted({0, 1, tile - 3, n // 2 + 17, max(n - tile // 2, 0)}):
        length = min(tile, n - s0)
        owners, centres, draws = _tile_owners(prefix, s0, length, window, threads)
        np.testing.assert_array_equal(owners, gid[s0:s0 + length])
        np.testing.assert_array_equal(centres, centre[s0:s0 + length])
        assert draws == [k for k in range(length) if not centre[s0 + k]]
