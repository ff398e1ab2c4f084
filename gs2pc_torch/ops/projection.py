"""Per-Gaussian camera preprocessing: project, EWA cov2D, conic, tile rect
(counterpart of gs2pc.ops.projection.preprocess, same formulas in the same
order; see that module for the derivations and reference citations)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs2pc_torch.ops.blend import TILE
from gs2pc_torch.ops.linalg3 import affine3, dotrow3, rot_factors3

NEAR_Z = 0.2  # frustum near cull: view z <= 0.2 is culled
H_VAR = 0.3  # low-pass dilation of the 2D covariance


class Preprocessed(NamedTuple):
    depth: torch.Tensor  # (P,) view-space z
    xy: torch.Tensor  # (P, 2) pixel-space centre
    conic: torch.Tensor  # (P, 3) inverse 2D covariance (A, B, C)
    opacity: torch.Tensor  # (P,)
    radius: torch.Tensor  # (P,) rect radius
    r_alpha_sq: torch.Tensor  # (P,) squared circle-cull radius (3.4e38 = never)
    radius_q: torch.Tensor  # (P,) radius within which alpha can reach 1/255
    rect_min: torch.Tensor  # (P, 2) int32 inclusive tile min (x, y)
    rect_max: torch.Tensor  # (P, 2) int32 exclusive tile max (x, y)
    tiles_touched: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def _tile_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(floor(x / TILE), 0, hi) as int32.  The float clamp comes first so
    an out-of-range or infinite value saturates instead of wrapping in the
    integer cast."""
    f = torch.floor(x / TILE).clamp(-1.0, float(hi) + 1.0)
    return f.to(torch.int32).clamp(0, hi)


def preprocess(
    means: torch.Tensor,
    cov_factors: torch.Tensor,
    opacities: torch.Tensor,
    alive: torch.Tensor,
    camera,
    adaptive_radius: bool = True,
) -> Preprocessed:
    """Project P Gaussians for one ``camera.Camera``.

    ``adaptive_radius`` shrinks the rect and the circle cull to the radius
    where alpha can still reach 1/255 (exact for the blend); the surface
    pass measures over the full 3-sigma rect, so callers computing surface
    distances pass False."""
    Rv = camera.viewmatrix[:3, :3]
    tv = camera.viewmatrix[:3, 3]
    p_view = affine3(means, Rv, tv)
    depth = p_view[:, 2]
    in_front = depth > NEAR_Z

    P = camera.projmatrix
    ph = affine3(means, P[:3, :3], P[:3, 3])
    pw = dotrow3(means, P[3, :3], P[3, 3])
    inv_w = 1.0 / (pw + 1e-7)
    width, height = camera.width, camera.height
    pix = torch.stack(
        [ndc2pix(ph[:, 0] * inv_w, width), ndc2pix(ph[:, 1] * inv_w, height)], dim=-1
    )

    # EWA 2D covariance on the factors: M2 = J W M3, cov2D = M2 M2^T + 0.3 I.
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    tz = torch.where(depth.abs() < 1e-6, torch.full_like(depth, 1e-6), depth)
    tx = torch.minimum(torch.maximum(p_view[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(p_view[:, 1] / tz, -limy), limy) * tz

    T0 = rot_factors3(Rv, cov_factors)
    inv_z = 1.0 / tz
    fx, fy = camera.focal_x, camera.focal_y
    row0 = (fx * inv_z)[:, None] * T0[:, 0, :] - (fx * tx * inv_z * inv_z)[:, None] * T0[:, 2, :]
    row1 = (fy * inv_z)[:, None] * T0[:, 1, :] - (fy * ty * inv_z * inv_z)[:, None] * T0[:, 2, :]
    cov_a = (row0 * row0).sum(-1)
    cov_b = (row0 * row1).sum(-1)
    cov_c = (row1 * row1).sum(-1)
    cov_a = cov_a + H_VAR
    cov_c = cov_c + H_VAR
    det = cov_a * cov_c - cov_b * cov_b

    invertible = det > 0.0
    det_inv = 1.0 / torch.where(invertible, det, torch.ones_like(det))
    conic = torch.stack([cov_c * det_inv, -cov_b * det_inv, cov_a * det_inv], dim=-1)

    mid = 0.5 * (cov_a + cov_c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda_max = mid + disc
    ln_term = torch.log(torch.clamp(255.0 * opacities, min=1e-12))
    lam = torch.clamp(lambda_max, min=0.0)
    r_alpha_true_sq = (2.0 * lam * torch.clamp(ln_term, min=0.0)) * 1.0001 + 1e-3
    if adaptive_radius:
        r_alpha_sq = r_alpha_true_sq
    else:
        r_alpha_sq = torch.full_like(lambda_max, 3.4e38)
    radius = torch.ceil(torch.sqrt(torch.minimum(9.0 * lam, r_alpha_sq)))
    radius_q = torch.ceil(torch.sqrt(torch.minimum(9.0 * lam, r_alpha_true_sq)))

    grid_w = (width + TILE - 1) // TILE
    grid_h = (height + TILE - 1) // TILE
    rmin_x = _tile_index(pix[:, 0] - radius, grid_w)
    rmin_y = _tile_index(pix[:, 1] - radius, grid_h)
    rmax_x = _tile_index(pix[:, 0] + radius + TILE - 1, grid_w)
    rmax_y = _tile_index(pix[:, 1] + radius + TILE - 1, grid_h)
    tiles_touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = alive & in_front & invertible & (tiles_touched > 0) & (opacities >= 1.0 / 255.0)
    return Preprocessed(
        depth=depth,
        xy=pix,
        conic=conic,
        opacity=opacities,
        radius=radius,
        r_alpha_sq=r_alpha_sq,
        radius_q=radius_q,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=tiles_touched,
        valid=valid,
    )


def mark_visible(means: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Frustum visibility check (gs2pc.ops.projection.mark_visible; parity:
    markVisible, rasterize_points.cu:147-166): view-space z > NEAR_Z.  The
    reference computes the NDC bound too but ignores it, so ``projmatrix``
    is unused, as in the JAX package."""
    del projmatrix
    return dotrow3(means, viewmatrix[2, :3], viewmatrix[2, 3]) > NEAR_Z
