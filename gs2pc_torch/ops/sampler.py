"""Point-budget distribution + exact truncated-normal sampling (counterpart
of gs2pc.ops.sampler).

Every point is ``x = mean_g + R_g (exp(s_g) * z)``; because x - mean = M z
with Sigma = M M^T, the Mahalanobis distance is |z|, so the reference's
rejection loop becomes an exact draw inside the ball |z| <= std: the
direction of a standard normal draw, and a radius from the inverse CDF of
the chi_3 distribution truncated to [0, std] by bisection.  Rank 0 of each
Gaussian's quota is its exact centre.

Randomness comes from an explicit ``torch.Generator``; ``sample_points``
also accepts injected draws so tests can feed it JAX's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


class SampledPoints(NamedTuple):
    points: torch.Tensor  # (n, 3) float32, n = min(sum of quotas, n_cap)
    gaussian_idx: torch.Tensor  # (n,) int64 source Gaussian


def sample_points(
    gaussians,
    points_per_gaussian: torch.Tensor,
    n_cap: int,
    mahalanobis_std: float = 2.0,
    max_points: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[tuple] = None,
) -> SampledPoints:
    """Draw every point of the cloud in one pass.

    Quotas beyond ``n_cap`` (or ``max_points``) are cut at the end of the
    slot order.  Randomness: ``generator`` draws zn (n, 3) standard normal
    and u (n,) uniform; ``draws = (zn, u)`` injects them instead (at least
    n rows each; slot i uses row i)."""
    ppg = points_per_gaussian.to(torch.int64)
    dev = ppg.device
    total = int(ppg.sum())
    if max_points is not None:
        total = min(total, int(max_points))
    n = min(total, n_cap)

    gid = torch.repeat_interleave(torch.arange(ppg.shape[0], device=dev), ppg)[:n]
    is_centre = torch.zeros(n, dtype=torch.bool, device=dev)
    first = (torch.cumsum(ppg, 0) - ppg)[ppg > 0]
    is_centre[first[first < n]] = True

    if draws is not None:
        zn = torch.as_tensor(draws[0], dtype=torch.float32, device=dev)[:n]
        u = torch.as_tensor(draws[1], dtype=torch.float32, device=dev)[:n]
    else:
        zn = torch.randn((n, 3), generator=generator, device=dev, dtype=torch.float32)
        u = torch.rand((n,), generator=generator, device=dev, dtype=torch.float32)
    r = chi3_truncated_radius(u, mahalanobis_std)
    norm = torch.sqrt((zn * zn).sum(-1))
    z = zn * (r / torch.clamp(norm, min=1e-12))[:, None]
    z = torch.where(is_centre[:, None], 0.0, z)

    scales = torch.exp(gaussians.log_scales[gid])
    pts = gaussians.xyz[gid] + quat_rotate(gaussians.rots[gid], scales * z)
    return SampledPoints(points=pts, gaussian_idx=gid)


def generate_pointcloud(
    generator: torch.Generator,
    gaussians,
    num_points: int,
    contributions: Optional[torch.Tensor] = None,
    mahalanobis_std: float = 2.0,
    exact_num_points: bool = False,
    n_cap: Optional[int] = None,
) -> SampledPoints:
    """The whole point generation (gs2pc.ops.sampler.generate_pointcloud,
    gauss_to_pc.py:277-371): size -> distribute -> flat sample, with the
    draws from ``generator`` (JAX takes a key).  ``exact_num_points``
    switches to largest-remainder quotas and a hard cap, so the cloud has
    exactly ``num_points`` points."""
    sizes = gaussians.magnitudes(contributions=contributions)
    ppg = distribute_points(sizes, num_points, exact=exact_num_points)
    if n_cap is None:
        # Rounding can overshoot the budget by at most ~P/2; a 5% + 4096
        # margin makes truncation practically impossible.
        n_cap = int(num_points + max(4096, num_points // 20))
    return sample_points(
        gaussians, ppg, n_cap=n_cap, mahalanobis_std=mahalanobis_std,
        max_points=num_points if exact_num_points else None, generator=generator,
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
