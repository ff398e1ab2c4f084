"""Per-Gaussian camera preprocessing: project, EWA cov2D, conic, tile rect
(counterpart of gs2pc.ops.projection.preprocess, same formulas in the same
order; see that module for the derivations and reference citations).

The JAX package compiles preprocess and the blend-table pack
(gs2pc.ops.rasterize.pack_blend_table) into one XLA fusion per camera; here
both are K6 (gs2pc_torch/csrc/project.cu), one launch a camera on CUDA
tensors: ``preprocess`` (the Preprocessed fields) and ``project_and_pack``
(with the table).  ``preprocess_torch`` is K6's plain twin, with
rasterize.pack_blend_table for the table, and what both run on CPU
tensors."""

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
    distances pass False.  K6 without a table on CUDA tensors,
    ``preprocess_torch`` on CPU tensors."""
    dev = means.device
    if dev.type == "cpu":
        return preprocess_torch(means, cov_factors, opacities, alive, camera, adaptive_radius)
    if dev.type != "cuda":
        raise ValueError(f"preprocess: unsupported device {dev}")
    return _k6(preprocess, means, cov_factors, opacities, alive, None, camera,
               adaptive_radius, 0)[0]


# K6 launches (without a table); a caller resets it (= 0).
preprocess.launches = 0


def project_and_pack(
    means: torch.Tensor,
    cov_factors: torch.Tensor,
    opacities: torch.Tensor,
    alive: torch.Tensor,
    colours: torch.Tensor,
    camera,
    cfg,
    adaptive_radius: bool = True,
):
    """``preprocess`` and the camera's blend table (P, 8) or (P, 16)
    (``cfg.compact``, a rasterize.TileConfig), as the JAX package's
    render_tile_camera fuses them: one K6 launch on CUDA tensors,
    ``preprocess_torch`` + rasterize.pack_blend_table on CPU tensors.
    Returns (Preprocessed, table)."""
    dev = means.device
    if dev.type == "cpu":
        from gs2pc_torch.ops.rasterize import pack_blend_table

        prep = preprocess_torch(means, cov_factors, opacities, alive, camera, adaptive_radius)
        return prep, pack_blend_table(prep, colours, compact=cfg.compact)
    if dev.type != "cuda":
        raise ValueError(f"project_and_pack: unsupported device {dev}")
    return _k6(project_and_pack, means, cov_factors, opacities, alive, colours, camera,
               adaptive_radius, 8 if cfg.compact else 16)


# K6 launches (with a table); a caller resets it (= 0).
project_and_pack.launches = 0


def _k6(wrapper, means, cov_factors, opacities, alive, colours, camera, adaptive_radius: bool,
        lanes: int):
    """One K6 launch on the tensors' card, counted on ``wrapper``: the
    Preprocessed fields and the table of ``lanes`` lanes (None for 0).  The
    camera's matrices and intrinsics are read on the card: no host sync."""
    from gs2pc_torch.ops.cuda_build import check, launch, load_library, stream_ptr

    dev = means.device
    P = means.shape[0]
    cam = [camera.viewmatrix, camera.projmatrix, camera.tanfovx, camera.tanfovy,
           camera.focal_x, camera.focal_y]
    floats = [means, cov_factors, opacities] + ([colours] if lanes else []) + cam
    shapes = [(P, 3), (P, 3, 3), (P,)] + ([(P, 3)] if lanes else []) + [(4, 4), (4, 4)]
    if (any(t.dtype != torch.float32 or t.device != dev for t in floats)
            or alive.dtype != torch.bool or alive.device != dev or alive.shape != (P,)
            or any(tuple(t.shape) != s for t, s in zip(floats, shapes))
            or any(t.numel() != 1 for t in cam[2:])):
        raise ValueError("K6: float32 means (P, 3), factors (P, 3, 3), opacities (P,), "
                         "colours (P, 3), a bool alive (P,) and the camera on one card")
    means, cov_factors, opac, colours = (
        None if t is None else t.contiguous() for t in (means, cov_factors, opacities, colours))
    cam = [t.contiguous() for t in cam]
    flags = alive.contiguous().view(torch.uint8)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    depth, radius, r_alpha_sq, radius_q = (torch.empty(P, **f32) for _ in range(4))
    xy, conic = torch.empty(P, 2, **f32), torch.empty(P, 3, **f32)
    rect_min, rect_max = torch.empty(P, 2, **i32), torch.empty(P, 2, **i32)
    tiles = torch.empty(P, **i32)
    valid = torch.empty(P, dtype=torch.uint8, device=dev)
    table = torch.empty(P, lanes, **f32) if lanes else None
    lib = load_library()
    rc = launch(
        lib.gs2pc_project_pack, means,
        means.data_ptr(), cov_factors.data_ptr(), opac.data_ptr(), flags.data_ptr(),
        colours.data_ptr() if lanes else None, *(t.data_ptr() for t in cam),
        P, camera.width, camera.height, int(adaptive_radius), lanes,
        depth.data_ptr(), xy.data_ptr(), conic.data_ptr(), radius.data_ptr(),
        r_alpha_sq.data_ptr(), radius_q.data_ptr(), rect_min.data_ptr(), rect_max.data_ptr(),
        tiles.data_ptr(), valid.data_ptr(), table.data_ptr() if lanes else None,
        stream_ptr(means),
    )
    wrapper.launches += 1
    check(rc, "gs2pc_project_pack")
    prep = Preprocessed(
        depth=depth, xy=xy, conic=conic, opacity=opacities, radius=radius,
        r_alpha_sq=r_alpha_sq, radius_q=radius_q, rect_min=rect_min, rect_max=rect_max,
        tiles_touched=tiles, valid=valid.view(torch.bool),
    )
    return prep, table


def preprocess_torch(
    means: torch.Tensor,
    cov_factors: torch.Tensor,
    opacities: torch.Tensor,
    alive: torch.Tensor,
    camera,
    adaptive_radius: bool = True,
) -> Preprocessed:
    """The plain PyTorch twin of K6's Preprocessed half, eager on any
    device.  K6 repeats its float operations in this order; the three-term
    sums of cov2D are written out left to right (equal to ``.sum(-1)`` on
    the CPU; on the card the reduction's order is ATen's to choose)."""
    preprocess_torch.calls += 1
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
    cov_a = _sum3(row0 * row0)
    cov_b = _sum3(row0 * row1)
    cov_c = _sum3(row1 * row1)
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


# Calls of the twin (on any device); a caller resets it (= 0).
preprocess_torch.calls = 0


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (v0 + v1) + v2."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def mark_visible(means: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Frustum visibility check (gs2pc.ops.projection.mark_visible; parity:
    markVisible, rasterize_points.cu:147-166): view-space z > NEAR_Z.  The
    reference computes the NDC bound too but ignores it, so ``projmatrix``
    is unused, as in the JAX package."""
    del projmatrix
    return dotrow3(means, viewmatrix[2, :3], viewmatrix[2, 3]) > NEAR_Z
