"""Repair of dense covariance matrices from outside the factor form
(counterpart of gs2pc.ops.covariance): the reference's matrix-space
pipeline, eps-regularise -> eigen-clamp x3 -> cull what stays non-PSD.
The pipeline's own covariances are PSD by construction; these serve
``Gaussians.from_covariances``."""

from __future__ import annotations

from typing import Optional

import torch

from gs2pc_torch.ops.eig3 import min_eigval_sym3
from gs2pc_torch.ops.linalg3 import eig_recompose3

# Matrices per batched eigh: cuSOLVER's batched solver takes 16384 3x3
# matrices and refuses 65536 (CUSOLVER_STATUS_INVALID_VALUE on an H100);
# each matrix is solved on its own, so the chunks change no value.
EIGH_CHUNK = 1 << 14


def eigh3(covariances: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of (N, 3, 3) symmetric matrices, EIGH_CHUNK at a
    time."""
    parts = [torch.linalg.eigh(covariances[i:i + EIGH_CHUNK])
             for i in range(0, covariances.shape[0], EIGH_CHUNK)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([w for w, _ in parts]), torch.cat([v for _, v in parts])


def non_posdef_mask(covariances: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """True where a covariance is NOT positive-definite (any eigenvalue <= eps)."""
    return min_eigval_sym3(covariances) <= epsilon


def regularise_covariances(
    covariances: torch.Tensor, mask: Optional[torch.Tensor] = None, epsilon: float = 5e-7
) -> torch.Tensor:
    """Add eps * I to the (masked) covariances."""
    eye = epsilon * torch.eye(3, dtype=covariances.dtype, device=covariances.device)
    if mask is None:
        return covariances + eye
    return torch.where(mask[:, None, None], covariances + eye, covariances)


def clamp_covariances(
    covariances: torch.Tensor, mask: Optional[torch.Tensor] = None, epsilon: float = 1e-6
) -> torch.Tensor:
    """Clamp the eigenvalues to >= eps (batched ``eigh``) and recompose."""
    eigvals, eigvecs = eigh3(covariances)
    eigvals = torch.clamp(eigvals, min=epsilon)
    fixed = eig_recompose3(eigvecs, eigvals)
    if mask is None:
        return fixed
    return torch.where(mask[:, None, None], fixed, covariances)


def validate_covariance_matrices(
    covariances: torch.Tensor,
    regularise: bool = True,
    epsilon: float = 1e-7,
    min_ps_epsilon: float = 1e-8,
    num_clamp_iters: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(repaired covariances, keep mask): keep is False for the covariances
    that stay non-PSD after ``num_clamp_iters`` clamps."""
    covs = regularise_covariances(covariances) if regularise else covariances
    for _ in range(num_clamp_iters):
        bad = non_posdef_mask(covs, epsilon=epsilon)
        covs = clamp_covariances(covs, mask=bad, epsilon=epsilon)
    keep = ~non_posdef_mask(covs, epsilon=min_ps_epsilon)
    return covs, keep
