"""Quaternion utilities, wxyz convention (counterpart of gs2pc.ops.quaternion)."""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit wxyz quaternions -> (..., 3, 3) rotation matrices."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise quaternions along the last axis."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) wxyz quaternions with w >= 0.

    Shepperd's construction without branches: the four 4 q_i^2 candidates
    are computed and the largest chosen per element, so rotations near pi
    (trace -1) take a stable axis branch."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    cand = torch.stack([tw, tx, ty, tz], dim=-1)
    best = torch.argmax(cand, dim=-1)
    s = torch.sqrt(torch.clamp(torch.gather(cand, -1, best[..., None]), min=1e-12))[..., 0]
    half_s = 0.5 * s
    quarter = 0.25 / half_s

    # m21 - m12 = 4wx, m02 - m20 = 4wy, m10 - m01 = 4wz, m01 + m10 = 4xy,
    # m02 + m20 = 4xz, m12 + m21 = 4yz (quat_to_rotmat's layout).
    q_w = torch.stack(
        [half_s, (m21 - m12) * quarter, (m02 - m20) * quarter, (m10 - m01) * quarter], dim=-1
    )
    q_x = torch.stack(
        [(m21 - m12) * quarter, half_s, (m01 + m10) * quarter, (m02 + m20) * quarter], dim=-1
    )
    q_y = torch.stack(
        [(m02 - m20) * quarter, (m01 + m10) * quarter, half_s, (m12 + m21) * quarter], dim=-1
    )
    q_z = torch.stack(
        [(m10 - m01) * quarter, (m02 + m20) * quarter, (m12 + m21) * quarter, half_s], dim=-1
    )
    stacked = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = normalize(torch.gather(stacked, -2, idx)[..., 0, :])
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) wxyz quaternions."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)
