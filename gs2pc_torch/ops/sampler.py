"""Point-budget distribution + exact truncated-normal sampling (counterpart
of gs2pc.ops.sampler).

Every point is ``x = mean_g + R_g (exp(s_g) * z)``; because x - mean = M z
with Sigma = M M^T, the Mahalanobis distance is |z|, so the reference's
rejection loop becomes an exact draw inside the ball |z| <= std: the
direction of a standard normal draw, and a radius from the inverse CDF of
the chi_3 distribution truncated to [0, std] by bisection.  Rank 0 of each
Gaussian's quota is its exact centre.

The draws are JAX's own (gs2pc_torch.ops.prng: threefry keyed on each
slot's global counter), so the port's cloud equals the JAX package's for
the same seed, and any block of slots can be sampled apart (the SPMD
conversion's point-axis split).  ``sample_points`` launches K5
(gs2pc_torch/csrc/sampler.cu) on CUDA tensors and runs its twin,
``sample_points_torch``, on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gs2pc_torch.ops import prng
from gs2pc_torch.ops.quaternion import quat_rotate

_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT_2 = 0.7071067811865476


def distribute_points(
    gaussian_sizes: torch.Tensor,
    num_points: int,
    mask: Optional[torch.Tensor] = None,
    exact: bool = False,
) -> torch.Tensor:
    """Integer quota per Gaussian, proportional to size (int32).

    Default: round(size * N / sum), then zero-quota Gaussians eligible under
    ``mask`` are promoted to 1 in index order while budget remains.
    ``exact``: largest-remainder apportionment, so the quotas sum to
    exactly ``num_points`` (ties broken by index)."""
    sizes = gaussian_sizes.to(torch.float32)
    if mask is not None:
        sizes = torch.where(mask, sizes, 0.0)
    total = sizes.sum()
    raw = sizes * (num_points / torch.clamp(total, min=1e-20))

    if exact:
        eligible = sizes > 0.0
        fl = torch.floor(raw)
        base = torch.where(eligible, fl.to(torch.int32), 0)
        rem = num_points - base.sum()
        frac = torch.where(eligible, raw - fl, -1.0)
        order = torch.argsort(-frac, stable=True)
        bump_rank = torch.empty_like(order)
        bump_rank[order] = torch.arange(order.shape[0], device=order.device)
        n_elig = eligible.sum()
        bump = eligible & (bump_rank < torch.clamp(torch.minimum(rem, n_elig), min=0))
        return base + bump.to(torch.int32)

    ppg = torch.round(raw).to(torch.int32)
    deficit = num_points - ppg.sum()
    zeros = ppg == 0
    if mask is not None:
        zeros = zeros & mask
    zero_rank = torch.cumsum(zeros.to(torch.int64), 0) - 1
    promote = torch.clamp(torch.minimum(deficit, zeros.sum()), min=0)
    return torch.where(zeros & (zero_rank < promote), 1, ppg).to(torch.int32)


def _chi3_cdf(r: torch.Tensor) -> torch.Tensor:
    """CDF of the chi distribution with 3 degrees of freedom."""
    return torch.erf(r * _INV_SQRT_2) - _SQRT_2_OVER_PI * r * torch.exp(-0.5 * r * r)


def chi3_truncated_radius(u: torch.Tensor, std: float, iters: int = 26) -> torch.Tensor:
    """Inverse CDF of chi_3 truncated to [0, std], by bisection.  The bracket
    caps at 16, beyond which the f32 CDF is saturated, so the resolution
    stays absolute for an effectively untruncated std."""
    std_t = torch.tensor(std, dtype=torch.float32, device=u.device)
    t = u * _chi3_cdf(std_t)
    lo = torch.zeros_like(u)
    hi = torch.full_like(u, min(float(std_t), 16.0))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = _chi3_cdf(mid) < t
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def chi3_table(std: float, levels: int, device=None) -> torch.Tensor:
    """K5's threshold table: chi3_cdf(mid) at every node n in [1, 2^levels)
    of the bisection tree of chi3_truncated_radius (entry 0 unused).  Node
    n's decisions are its bits below the leading one, 1 = "below" (lo =
    mid), taken from [0, min(std, 16)] with the bisection's own float
    operations."""
    hi0 = min(float(torch.tensor(std, dtype=torch.float32)), 16.0)
    lo = torch.zeros(1 << levels, dtype=torch.float32, device=device)
    hi = torch.full_like(lo, hi0)
    for d in range(1, levels):
        node = torch.arange(1 << d, 2 << d, device=device)
        parent, below = node >> 1, (node & 1).bool()
        mid = 0.5 * (lo[parent] + hi[parent])
        lo[node] = torch.where(below, mid, lo[parent])
        hi[node] = torch.where(below, hi[parent], mid)
    return _chi3_cdf(0.5 * (lo + hi))


def chi3_radius_by_table(u: torch.Tensor, std: float, levels: int,
                         iters: int = 26) -> torch.Tensor:
    """chi3_truncated_radius as K5 takes it, bit for bit: the first
    ``levels`` rounds compare t with chi3_table's entry at the node the
    decisions so far reach (lo / hi still updated round by round), the rest
    evaluate the CDF.  The tests hold it to chi3_truncated_radius; the
    sampler does not call it."""
    table = chi3_table(std, levels, u.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=u.device)
    t = u * _chi3_cdf(std_t)
    lo = torch.zeros_like(u)
    hi = torch.full_like(u, min(float(std_t), 16.0))
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    for it in range(iters):
        mid = 0.5 * (lo + hi)
        below = (table[node] if it < levels else _chi3_cdf(mid)) < t
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
        node = 2 * node + below.long()
    return 0.5 * (lo + hi)


class SampledPoints(NamedTuple):
    points: torch.Tensor  # (m, 3) float32: slots [lo, hi) of the n = min(quota sum, n_cap)
    gaussian_idx: torch.Tensor  # (m,) int64 source Gaussian


class SamplerScene(NamedTuple):
    """What the sampler reads of a scene (a Gaussians has these fields)."""

    xyz: torch.Tensor  # (P, 3) float32
    log_scales: torch.Tensor  # (P, 3) float32
    rots: torch.Tensor  # (P, 4) float32, wxyz


def slot_prefix(points_per_gaussian: torch.Tensor, n_cap: int,
                max_points: Optional[int] = None) -> tuple:
    """(prefix, n): the inclusive int64 prefix sum of the quotas, on their
    device, and n, the slots sampled: the quota sum cut at ``max_points``
    and ``n_cap`` (quotas beyond are dropped at the end of the slot order).
    Reading the sum is the one host sync."""
    prefix = torch.cumsum(points_per_gaussian, 0, dtype=torch.int64)
    total = int(prefix[-1]) if prefix.numel() else 0
    if max_points is not None:
        total = min(total, int(max_points))
    return prefix, min(total, n_cap)


def _block(block: Optional[tuple], n: int) -> tuple:
    lo, hi = (0, n) if block is None else (int(block[0]), int(block[1]))
    hi = min(max(hi, 0), n)
    return min(max(lo, 0), hi), hi


def sample_points(
    key: torch.Tensor,
    gaussians,
    points_per_gaussian: torch.Tensor,
    n_cap: int,
    mahalanobis_std: float = 2.0,
    max_points: Optional[int] = None,
    draws: Optional[tuple] = None,
    block: Optional[tuple] = None,
    prefix: Optional[tuple] = None,
) -> SampledPoints:
    """Slots ``block`` = [lo, hi) (default: all n, see slot_prefix) of the
    cloud, with JAX's draws under ``key`` (gs2pc_torch.ops.prng; JAX's
    sample_points(key, ...) with the same key draws the same numbers).
    ``prefix`` is slot_prefix(points_per_gaussian, n_cap, max_points) where
    the caller has it already (computed here otherwise).

    Each slot's values depend on the slot alone, so blocks concatenated in
    order equal the whole range bit for bit.  K5 (gs2pc_torch/csrc/
    sampler.cu) for CUDA tensors; for CPU tensors its twin,
    sample_points_torch, which alone takes injected ``draws = (zn, u)``
    (rows indexed by slot)."""
    dev = points_per_gaussian.device
    if dev.type == "cpu":
        return sample_points_torch(key, gaussians, points_per_gaussian, n_cap, mahalanobis_std,
                                   max_points, draws, block, prefix)
    if dev.type != "cuda":
        raise ValueError(f"sample_points: unsupported device {dev}")
    if draws is not None:
        raise ValueError("sample_points: injected draws run on the CPU twin only")
    from gs2pc_torch.ops.cuda_build import check, launch, load_library, stream_ptr

    P = points_per_gaussian.shape[0]
    xyz, log_scales, rots = (t.contiguous() for t in (gaussians.xyz, gaussians.log_scales,
                                                      gaussians.rots))
    for name, t, w in (("xyz", xyz, 3), ("log_scales", log_scales, 3), ("rots", rots, 4)):
        if t.dtype != torch.float32 or t.shape != (P, w) or t.device != dev:
            raise ValueError(f"sample_points: {name} must be a ({P}, {w}) float32 tensor on {dev}")
    # The key words and the library first: host work done before the sync.
    (kz0, kz1), (ku0, ku1) = prng.split_words(key)
    lib = load_library()
    prefix, n = slot_prefix(points_per_gaussian, n_cap, max_points) if prefix is None else prefix
    lo, hi = _block(block, n)
    points = torch.empty((hi - lo, 3), dtype=torch.float32, device=dev)
    gid = torch.empty(hi - lo, dtype=torch.int64, device=dev)
    if hi > lo:
        rc = launch(
            lib.gs2pc_sample_points, prefix, prefix.data_ptr(), P, xyz.data_ptr(),
            log_scales.data_ptr(), rots.data_ptr(), lo, hi - lo, kz0, kz1, ku0, ku1,
            float(mahalanobis_std), points.data_ptr(), gid.data_ptr(), stream_ptr(prefix),
        )
        sample_points.launches += 1
        check(rc, "gs2pc_sample_points")
    return SampledPoints(points=points, gaussian_idx=gid)


# Kernel launches (an empty block launches nothing); a caller resets it (= 0).
sample_points.launches = 0


def sample_points_torch(
    key: torch.Tensor,
    gaussians,
    points_per_gaussian: torch.Tensor,
    n_cap: int,
    mahalanobis_std: float = 2.0,
    max_points: Optional[int] = None,
    draws: Optional[tuple] = None,
    block: Optional[tuple] = None,
    prefix: Optional[tuple] = None,
) -> SampledPoints:
    """K5's twin, on any device: the slot's owner by a search of the quota
    prefix (``prefix`` as sample_points takes it), its draws from
    gs2pc_torch.ops.prng at the global slot counters (or rows of
    ``draws``), then the radius, direction, scale and rotation in K5's
    order of float operations."""
    ppg = points_per_gaussian.to(torch.int64)
    dev = ppg.device
    prefix, n = slot_prefix(ppg, n_cap, max_points) if prefix is None else prefix
    lo, hi = _block(block, n)
    slots = torch.arange(lo, hi, device=dev)
    gid = torch.searchsorted(prefix, slots, right=True)
    is_centre = slots == prefix[gid] - ppg[gid]

    if draws is not None:
        zn = torch.as_tensor(draws[0], dtype=torch.float32, device=dev)[lo:hi]
        u = torch.as_tensor(draws[1], dtype=torch.float32, device=dev)[lo:hi]
    else:
        kz, ku = prng.split(key)
        zn = prng.normal(kz, 3 * lo, 3 * hi, device=dev).view(-1, 3)
        u = prng.uniform(ku, lo, hi, device=dev)
    r = chi3_truncated_radius(u, mahalanobis_std)
    zx, zy, zz = zn.unbind(1)
    norm = torch.sqrt(zx * zx + zy * zy + zz * zz)
    z = zn * (r / torch.clamp(norm, min=1e-12))[:, None]
    z = torch.where(is_centre[:, None], 0.0, z)

    scales = torch.exp(gaussians.log_scales[gid])
    pts = gaussians.xyz[gid] + quat_rotate(gaussians.rots[gid], scales * z)
    return SampledPoints(points=pts, gaussian_idx=gid)


def generate_pointcloud(
    key: torch.Tensor,
    gaussians,
    num_points: int,
    contributions: Optional[torch.Tensor] = None,
    mahalanobis_std: float = 2.0,
    exact_num_points: bool = False,
    n_cap: Optional[int] = None,
) -> SampledPoints:
    """The whole point generation (gs2pc.ops.sampler.generate_pointcloud,
    gauss_to_pc.py:277-371): size -> distribute -> flat sample, with JAX's
    draws under ``key``.  ``exact_num_points`` switches to
    largest-remainder quotas and a hard cap, so the cloud has exactly
    ``num_points`` points."""
    sizes = gaussians.magnitudes(contributions=contributions)
    ppg = distribute_points(sizes, num_points, exact=exact_num_points)
    if n_cap is None:
        # Rounding can overshoot the budget by at most ~P/2; a 5% + 4096
        # margin makes truncation practically impossible.
        n_cap = int(num_points + max(4096, num_points // 20))
    return sample_points(
        key, gaussians, ppg, n_cap=n_cap, mahalanobis_std=mahalanobis_std,
        max_points=num_points if exact_num_points else None,
    )


def mahalanobis(means: torch.Tensor, samples: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Explicit Mahalanobis distance sqrt(d^T Sigma^-1 d), d = means - samples
    (gs2pc.ops.sampler.mahalanobis; parity: gauss_to_pc.py:92-103), for
    (..., 3) points and (..., 3, 3) covariances.  The batched solve runs in
    float64, whatever the caller's TF32 settings, and the distance comes
    back in the inputs' dtype.  The sampler does not use it (its distance
    is |z|)."""
    delta = (means - samples).to(torch.float64)
    sol = torch.linalg.solve(covs.to(torch.float64), delta[..., None])[..., 0]
    return torch.sqrt(torch.clamp((delta * sol).sum(-1), min=0.0)).to(means.dtype)
