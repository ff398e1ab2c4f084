"""Front-to-back compositing constants and the per-camera render product
(counterpart of the constants and ``RenderOutput`` of gs2pc.ops.blend).

Blend semantics, shared by the CUDA tile kernel and its PyTorch twin
(gs2pc_torch.ops.blend_kernel): power = -0.5 (A dx^2 + C dy^2) - B dx dy,
skipped if > 0; alpha = min(0.99, opacity exp(power)), skipped if < 1/255;
if T (1 - alpha) < 1e-4 the pixel is done and that Gaussian is NOT
composited; otherwise w = alpha T is composited and T *= 1 - alpha.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16  # tile edge in pixels; one CUDA block of TILE * TILE threads per tile
BACKGROUND = 1.0  # white, as the JAX sweep renders by default
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
FLOAT_MAX = float(torch.finfo(torch.float32).max)


class RenderOutput(NamedTuple):
    """Per-camera render products (padded image dims)."""

    image: torch.Tensor  # (Hp, Wp, 3)
    depth: torch.Tensor  # (Hp, Wp) expected depth
    invdepth: torch.Tensor  # (Hp, Wp) expected inverse depth
    radii: torch.Tensor  # (P,) pixel radii
    contrib: torch.Tensor  # (P,) per-image max contribution alpha*T
    best_colour: torch.Tensor  # (P, 3) rendered colour at the argmax pixel
    surf_dist: torch.Tensor  # (P,) min |depth_g - expected depth|, FLOAT_MAX if none
    # Populated on request, for the depth-slab renderer: the final per-pixel
    # transmittance (its cross-slab prefix) and each Gaussian's best pixel
    # (to re-gather its colour from the combined image).
    trans: Optional[torch.Tensor] = None  # (Hp, Wp)
    best_pix: Optional[torch.Tensor] = None  # (P,) int64 padded row-major pixel id
    # (4,) f64 counters [pairs blended, window-truncated (always 0 on one
    # camera; slab overflow on the depth-slab path), run-cap-dropped pairs,
    # run-cap drops on tiles with live pixels].  Float64 keeps the sums of
    # pair counts exact past 2^24.
    n_dropped: Optional[torch.Tensor] = None
