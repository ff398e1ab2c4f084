"""Closed-form eigenvalues of symmetric 3x3 matrices (counterpart of
gs2pc.ops.eig3): the trigonometric solution of the characteristic cubic
(Smith 1961), elementwise over any batch shape, in the same order of
operations."""

from __future__ import annotations

import math

import torch


def eigvals_sym3(A: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    # Floor p itself (not p^2) so p**3 cannot underflow f32 for
    # near-isotropic matrices.
    p = torch.clamp(torch.sqrt(torch.clamp(p2 / 6.0, min=0.0)), min=eps)

    # det(B) / (2 p^3) with B = A - q I
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)

    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def min_eigval_sym3(A: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of symmetric (..., 3, 3) matrices."""
    return eigvals_sym3(A)[..., 0]
