"""Spherical-harmonics colour evaluation, degrees 0-4 (counterpart of
gs2pc.ops.sh): the same constants and the same order of operations, as
plain tensor functions on any device."""

from __future__ import annotations

from typing import Optional

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_dc_to_rgb(sh_dc: torch.Tensor) -> torch.Tensor:
    """Degree-0 coefficients (..., 3) -> RGB in [0, 1]: 0.5 + C0 * sh, clipped."""
    return torch.clamp(SH_C0 * sh_dc + 0.5, 0.0, 1.0)


def eval_sh(deg: int, sh: torch.Tensor, dirs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SH colour (..., C) of coefficients ``sh`` (..., C, (deg+1)**2) along
    unit directions ``dirs`` (..., 3) (needed for deg > 0); no +0.5 offset
    (see ``eval_sh_rgb``)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} is outside 0-4")
    if sh.shape[-1] < (deg + 1) ** 2:
        raise ValueError(f"{sh.shape[-1]} SH coefficients are too few for degree {deg}")

    result = SH_C0 * sh[..., 0]
    if deg > 0:
        if dirs is None:
            raise ValueError("SH degrees above 0 need view directions")
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh[..., 1]
            + SH_C1 * z * sh[..., 2]
            - SH_C1 * x * sh[..., 3]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4]
                + SH_C2[1] * yz * sh[..., 5]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + SH_C2[3] * xz * sh[..., 7]
                + SH_C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + SH_C3[1] * xy * z * sh[..., 10]
                    + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14]
                    + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
                if deg > 3:
                    result = (
                        result
                        + SH_C4[0] * xy * (xx - yy) * sh[..., 16]
                        + SH_C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                        + SH_C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                        + SH_C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                        + SH_C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                        + SH_C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                        + SH_C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                        + SH_C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                        + SH_C4[8]
                        * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
                        * sh[..., 24]
                    )
    return result


def eval_sh_rgb(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rasterizer-style SH -> RGB: ``max(eval_sh + 0.5, 0)``."""
    return torch.clamp(eval_sh(deg, sh, dirs) + 0.5, min=0.0)


def view_colours(deg: int, shs: torch.Tensor, means: torch.Tensor,
                 campos: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian colours seen from ``campos``: the SH of each Gaussian
    along the unit direction from the camera to its centre."""
    dirs = means - campos
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    return eval_sh_rgb(deg, shs, dirs)
