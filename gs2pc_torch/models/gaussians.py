"""Gaussian scene container in factor form (counterpart of
gs2pc.models.gaussians).

The scene keeps log-scales ``s`` and unit wxyz quaternions ``q``; the
covariance factor is M = R(q) diag(exp s) and Sigma = M M^T, so the PSD
repair is a clamp on ``s`` and the sampler draws ``x = mean + M z``.
Culls AND into ``keep_mask`` and nothing is compacted on the device.

Methods return new containers (``dataclasses.replace``) and never write
into the tensors they were given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gs2pc_torch.ops.quaternion import quat_to_rotmat

# Knud Thomsen's ellipsoid surface-area exponent.
_KT_P = 1.6075

# PSD log-scale floor: eig(Sigma) = exp(2 s) >= 1e-7.
PSD_LOG_FLOOR = 0.5 * float(np.log(1e-7))


def _f32(x, device) -> torch.Tensor:
    # Copies only when the array is not already contiguous, writable float32.
    return torch.as_tensor(np.require(x, np.float32, ["C", "W"]), device=device)


@dataclasses.dataclass(frozen=True)
class Gaussians:
    """3DGS scene on one device.

    xyz (P, 3), log_scales (P, 3), rots (P, 4) wxyz, opacities (P,) in
    [0, 1], colours (P, 3) in [0, 1] until the pipeline scales them to
    0-255, optional shs (P, 3, K) and normals (P, 3), keep_mask (P,) bool.
    """

    xyz: torch.Tensor
    log_scales: torch.Tensor
    rots: torch.Tensor
    opacities: torch.Tensor
    colours: torch.Tensor
    shs: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None
    keep_mask: Optional[torch.Tensor] = None

    @staticmethod
    def from_numpy(
        xyz, log_scales, rots, colours, opacities, shs=None, *, device
    ) -> "Gaussians":
        """Host arrays -> a float32 scene on ``device`` with every row kept."""
        xyz_t = _f32(xyz, device)
        return Gaussians(
            xyz=xyz_t,
            log_scales=_f32(log_scales, device),
            rots=_f32(rots, device),
            opacities=_f32(opacities, device).reshape(-1),
            colours=_f32(colours, device),
            shs=None if shs is None else _f32(shs, device),
            normals=None,
            keep_mask=torch.ones(xyz_t.shape[0], dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_jax_fields(g, *, device) -> "Gaussians":
        """Copy a ``gs2pc.models.gaussians.Gaussians`` field by field.

        Every field goes through ``np.asarray``, so this module needs no
        JAX import; the tests use it to hand both packages one scene."""

        def conv(x, dtype=np.float32):
            return None if x is None else torch.tensor(np.asarray(x, dtype), device=device)

        return Gaussians(
            xyz=conv(g.xyz),
            log_scales=conv(g.log_scales),
            rots=conv(g.rots),
            opacities=conv(g.opacities).reshape(-1),
            colours=conv(g.colours),
            shs=conv(g.shs),
            normals=conv(g.normals),
            keep_mask=conv(g.keep_mask, bool),
        )

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ------------------------------------------------------------------ #
    # Derived geometry
    # ------------------------------------------------------------------ #
    def rotation_matrices(self) -> torch.Tensor:
        return quat_to_rotmat(self.rots)

    def covariance_factors(self) -> torch.Tensor:
        """(P, 3, 3) factor M = R diag(exp s); Sigma = M M^T."""
        return self.rotation_matrices() * torch.exp(self.log_scales)[:, None, :]

    def calculate_normals(self) -> "Gaussians":
        """Normal = the rotation column of the smallest scale axis."""
        k = torch.argmin(self.log_scales, dim=1)
        R = self.rotation_matrices()
        normals = torch.gather(R, 2, k[:, None, None].expand(-1, 3, 1))[..., 0]
        return dataclasses.replace(self, normals=normals)

    def validate_covariances(self, epsilon: float = 1e-7) -> "Gaussians":
        """Clamp log-scales so every Sigma is positive-definite (the
        eigenvalue clamp exp(2 s) >= epsilon, done in log space)."""
        floor = PSD_LOG_FLOOR if epsilon == 1e-7 else 0.5 * math.log(epsilon)
        return dataclasses.replace(
            self, log_scales=torch.clamp(self.log_scales, min=floor)
        )

    def magnitudes(self, contributions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sqrt(Knud-Thomsen ellipsoid area) * contribution (or opacity)."""
        a = torch.exp(self.log_scales[:, 0])
        b = torch.exp(self.log_scales[:, 1])
        c = torch.exp(self.log_scales[:, 2])
        p = _KT_P
        radicand = ((a * b) ** p + (a * c) ** p + (b * c) ** p) / 3.0
        surface_area = 4.0 * math.pi * radicand ** (1.0 / p)
        size = torch.sqrt(surface_area)
        if contributions is None:
            contributions = self.opacities
        return size * contributions

    # ------------------------------------------------------------------ #
    # Cull predicates (ANDed into keep_mask)
    # ------------------------------------------------------------------ #
    def add_to_cull(self, keep: torch.Tensor) -> "Gaussians":
        return dataclasses.replace(self, keep_mask=self.keep_mask & keep)

    def apply_min_opacity(self, min_opacity: float) -> "Gaussians":
        if min_opacity > 0.0:
            return self.add_to_cull(self.opacities > min_opacity)
        return self

    def apply_bounding_box(self, bb_min, bb_max) -> "Gaussians":
        g = self
        if bb_min is not None:
            lo = torch.as_tensor(bb_min, dtype=torch.float32, device=g.device)
            g = g.add_to_cull(torch.all(g.xyz > lo, dim=1))
        if bb_max is not None:
            hi = torch.as_tensor(bb_max, dtype=torch.float32, device=g.device)
            g = g.add_to_cull(torch.all(g.xyz < hi, dim=1))
        return g

    def cull_large_gaussians(self, cull_percent: float) -> "Gaussians":
        """Keep the smallest floor(P * (1 - cull_percent)) by magnitude."""
        if cull_percent <= 0.0:
            return self
        cull_index = int(np.floor(self.num_gaussians * (1.0 - cull_percent)))
        order = torch.argsort(self.magnitudes(), stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(order.shape[0], device=order.device)
        return self.add_to_cull(ranks < cull_index)
