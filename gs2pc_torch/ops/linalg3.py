"""Dim-3 contractions in plain float32 torch (counterpart of
gs2pc.ops.linalg3).

The JAX package unrolls these into multiply-adds to keep them off the TPU's
bf16 matrix unit.  Here they are ordinary elementwise expressions in the
same term order, which keeps them in full float32 on every device and
close to the JAX values bit for bit; the pipeline additionally turns TF32
off (see gs2pc_torch.pipeline).
"""

from __future__ import annotations

import torch


def affine3(points: torch.Tensor, rows3: torch.Tensor, t3: torch.Tensor) -> torch.Tensor:
    """``points @ rows3.T + t3`` for (..., 3) points and a (3, 3) block."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack(
        [rows3[i, 0] * x + rows3[i, 1] * y + rows3[i, 2] * z + t3[i] for i in range(3)],
        dim=-1,
    )


def dotrow3(points: torch.Tensor, row3: torch.Tensor, b) -> torch.Tensor:
    """``points @ row3 + b`` for one (3,) row; returns (...,)."""
    return row3[0] * points[..., 0] + row3[1] * points[..., 1] + row3[2] * points[..., 2] + b


def rot_factors3(R: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``einsum('ij,pjk->pik', R, F)`` for a (3, 3) R and (P, 3, 3) F."""
    rows = [
        R[i, 0] * F[..., 0, :] + R[i, 1] * F[..., 1, :] + R[i, 2] * F[..., 2, :]
        for i in range(3)
    ]
    return torch.stack(rows, dim=-2)


def bmm33_nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched ``A @ B.transpose(-1, -2)`` for (..., 3, 3) operands:
    out[..., i, k] = sum_j A[..., i, j] * B[..., k, j]."""
    return (A[..., :, None, :] * B[..., None, :, :]).sum(-1)


def eig_recompose3(eigvecs: torch.Tensor, eigvals: torch.Tensor) -> torch.Tensor:
    """``V diag(w) V^T`` for (..., 3, 3) V and (..., 3) w."""
    return bmm33_nt(eigvecs * eigvals[..., None, :], eigvecs)
