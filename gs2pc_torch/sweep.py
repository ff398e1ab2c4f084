"""Single-device camera sweep + per-Gaussian accumulators (counterpart of
the single-device part of gs2pc.parallel.sweep).

  max_contribution      running max of the per-image max alpha*T
  colours               rendered colour at the winning pixel, [0, 1]
  total_contribution    SUM of the per-image max contributions
  min_surface_distance  running min |depth - expected depth|
  n_dropped             summed truncation counters (see RenderOutput)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gs2pc_torch.ops.blend import FLOAT_MAX, RenderOutput
from gs2pc_torch.ops.rasterize import TileConfig, render_tile_camera


class SweepAccumulators(NamedTuple):
    max_contribution: torch.Tensor  # (P,)
    colours: torch.Tensor  # (P, 3)
    total_contribution: torch.Tensor  # (P,)
    min_surface_distance: torch.Tensor  # (P,)
    n_dropped: Optional[torch.Tensor] = None  # (4,)


def init_accumulators(num_gaussians: int, *, device) -> SweepAccumulators:
    f32 = dict(dtype=torch.float32, device=device)
    return SweepAccumulators(
        max_contribution=torch.zeros(num_gaussians, **f32),
        colours=torch.zeros((num_gaussians, 3), **f32),
        total_contribution=torch.zeros(num_gaussians, **f32),
        min_surface_distance=torch.full((num_gaussians,), FLOAT_MAX, **f32),
        n_dropped=torch.zeros(4, **f32),
    )


def update_accumulators(acc: SweepAccumulators, out: RenderOutput) -> SweepAccumulators:
    """Strict ``>``: on equal contributions the earlier camera keeps its colour."""
    upd = out.contrib > acc.max_contribution
    return SweepAccumulators(
        max_contribution=torch.where(upd, out.contrib, acc.max_contribution),
        colours=torch.where(upd[:, None], out.best_colour, acc.colours),
        total_contribution=acc.total_contribution + out.contrib,
        min_surface_distance=torch.minimum(acc.min_surface_distance, out.surf_dist),
        n_dropped=acc.n_dropped + out.n_dropped,
    )


def render_sweep(
    gaussians, cameras, cfg: TileConfig, calc_surface_distance: bool = True
) -> SweepAccumulators:
    """Render every camera in turn and fold it into the accumulators."""
    means = gaussians.xyz
    cov_factors = gaussians.covariance_factors()
    acc = init_accumulators(gaussians.num_gaussians, device=means.device)
    for i in range(cameras.num_cameras):
        out = render_tile_camera(
            means, cov_factors, gaussians.opacities, gaussians.colours,
            gaussians.keep_mask, cameras.at(i), cfg,
            calc_surface_distance=calc_surface_distance,
        )
        acc = update_accumulators(acc, out)
    return acc
