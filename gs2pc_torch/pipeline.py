"""End-to-end conversion on one device: load -> camera sweep -> cull chain
-> PSD clamp -> sample -> host point cloud (counterpart of
gs2pc.pipeline.convert_3dgs_to_pc on one device).

Culled Gaussians stay in place with keep_mask False and get a zero point
quota, as in the JAX package, so every cull predicate sees the initial set.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gs2pc.utils.config import GaussPointCloudSettings
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.io.colmap import load_transform_data
from gs2pc_torch.io.gaussians_io import load_gaussians
from gs2pc_torch.io.masks import load_image_masks
from gs2pc_torch.io.ply import PointCloud
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops.blend import FLOAT_MAX
from gs2pc_torch.ops.rasterize import TileConfig
from gs2pc_torch.ops.sampler import distribute_points, sample_points
from gs2pc_torch.sweep import SweepAccumulators, render_sweep
from gs2pc_torch.utils import log

TRUNCATION_WARN_FRACTION = 0.005

# Settings whose feature this port does not have yet, with the number of
# the ROADMAP.md 'Still to port' item that ports it.  Each refuses to run
# rather than being ignored.
_UNSUPPORTED = (
    (lambda s: s.renderer_type != "tile", "--renderer_type dense|python", 1),
    (lambda s: s.sh_colour_eval, "--sh_colour_eval", 2),
    (lambda s: s.generate_mesh, "--generate_mesh", 4),
    (lambda s: s.save_sweep is not None, "--save_sweep", 5),
    (lambda s: s.load_sweep is not None, "--load_sweep", 5),
    (lambda s: s.shard_axis != "cams", "--shard_axis gauss|both", 6),
    (lambda s: s.auto_capacity, "--auto_capacity", 7),
)


def check_supported(settings: GaussPointCloudSettings) -> None:
    for unsupported, flag, item in _UNSUPPORTED:
        if unsupported(settings):
            raise_not_ported(flag, item)


def raise_not_ported(flag: str, item: int) -> None:
    raise ValueError(
        f"{flag} is not ported to gs2pc_torch yet (ROADMAP.md, 'Still to port' "
        f"item {item}); run it with python -m gs2pc"
    )


def set_precision() -> None:
    """Full float32 products: TF32 keeps ~3 decimal digits, the GPU form of
    the bf16 trap the JAX package hit in its K=3 geometry (DESIGN §7b)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def report_truncation(acc: SweepAccumulators) -> list:
    """Log the sweep's truncation counters and return them.  The pair
    expansion is exact, so only the per-tile run cap can drop pairs."""
    pairs, win_drop, cap_drop, cap_live = (float(x) for x in acc.n_dropped.cpu())
    if pairs == 0.0 and cap_drop == 0.0:
        return [pairs, win_drop, cap_drop, cap_live]
    log.info(
        f"Render pairs: {pairs:,.0f} blended; {cap_drop:,.0f} beyond the "
        f"per-tile cap ({cap_live:,.0f} on live tiles)"
    )
    if cap_live / max(pairs, 1.0) > TRUNCATION_WARN_FRACTION:
        log.warn(
            f"{cap_live:,.0f} pairs ({100.0 * cap_live / max(pairs, 1.0):.2f}% of "
            "blended) fell beyond the per-tile depth cap on tiles with visible "
            "transmittance; raise --max_pairs_per_tile"
        )
    return [pairs, win_drop, cap_drop, cap_live]


def surface_keep_mask(min_surface_distance: torch.Tensor, surface_std: float) -> torch.Tensor:
    """Keep dist < mean(finite dists) * std."""
    finite = min_surface_distance < FLOAT_MAX
    mean = torch.where(finite, min_surface_distance, 0.0).sum() / torch.clamp(finite.sum(), min=1)
    return min_surface_distance < mean * surface_std


def cull_chain(
    g: Gaussians, acc: SweepAccumulators, settings: GaussPointCloudSettings
) -> Gaussians:
    """Rendered colours (0-255 from here on) and every cull predicate."""
    g = dataclasses.replace(g, colours=acc.colours * 255.0)
    if settings.surface_distance_std is not None:
        keep = surface_keep_mask(acc.min_surface_distance, settings.surface_distance_std)
        g = g.add_to_cull(keep)
    if settings.remove_unrendered_gaussians:
        g = g.add_to_cull(acc.max_contribution > settings.visibility_threshold)
    g = g.apply_min_opacity(settings.min_opacity)
    g = g.apply_bounding_box(settings.bounding_box_min, settings.bounding_box_max)
    return g.cull_large_gaussians(settings.cull_large_percentage)


def tile_config(settings: GaussPointCloudSettings, width_pad: int, height_pad: int) -> TileConfig:
    return TileConfig(
        width_pad=width_pad,
        height_pad=height_pad,
        run_cap=settings.render.max_pairs_per_tile,
        run_chunk=settings.render.run_chunk,
        compact=settings.render.compact_pairs,
        surface_compact=settings.render.surface_compact,
    )


def generate_point_cloud(
    gaussians: Gaussians,
    settings: GaussPointCloudSettings,
    contributions: Optional[torch.Tensor] = None,
) -> PointCloud:
    """Quotas -> sampled positions -> host point cloud."""
    num_points = settings.num_points
    sizes = gaussians.magnitudes(contributions=contributions)
    sizes = torch.where(gaussians.keep_mask, sizes, 0.0)
    ppg = distribute_points(
        sizes, num_points, mask=gaussians.keep_mask, exact=settings.exact_num_points
    )
    n_cap = int(num_points + max(4096, num_points // 20))
    gen = torch.Generator(device=gaussians.device)
    gen.manual_seed(settings.seed)
    sampled = sample_points(
        gaussians, ppg, n_cap=n_cap,
        mahalanobis_std=settings.mahalanobis_distance_std,
        max_points=num_points if settings.exact_num_points else None,
        generator=gen,
    )
    total = sampled.points.shape[0]
    counts = ppg.cpu().numpy().astype(np.int64)
    cum = np.cumsum(counts)
    over = cum > total
    if over.any():  # quotas cut at n_cap / max_points: trim the tail runs
        first = int(np.argmax(over))
        counts[first] -= int(cum[first] - total)
        counts[first + 1:] = 0
    cols_u8 = torch.clamp(gaussians.colours, 0.0, 255.0).to(torch.uint8)
    return PointCloud(
        points=sampled.points.cpu().numpy(),
        counts=counts,
        cols_u8=cols_u8.cpu().numpy(),
        gauss_normals=None if gaussians.normals is None else gaussians.normals.cpu().numpy(),
    )


class Conversion(NamedTuple):
    cloud: PointCloud
    # Summed sweep counters [pairs blended, window-truncated, run-cap
    # dropped, run-cap dropped on live tiles]; None without a sweep.
    sweep_diag: Optional[list]


def run_render_sweep(gaussians, cameras, settings) -> SweepAccumulators:
    cfg = tile_config(settings, cameras.width_pad, cameras.height_pad)
    return render_sweep(
        gaussians, cameras, cfg,
        calc_surface_distance=settings.surface_distance_std is not None,
    )


def convert_3dgs_to_pc(
    input_path: str,
    transform_path: Optional[str],
    mask_path: Optional[str],
    settings: GaussPointCloudSettings,
    *,
    device,
) -> Conversion:
    """The full conversion on ``device``; returns the host point cloud."""
    check_supported(settings)
    set_precision()
    device = torch.device(device)
    log.set_quiet(settings.quiet)

    transforms = intrinsics = None
    if transform_path is not None:
        with log.phase("camera_poses"):
            transforms, intrinsics = load_transform_data(
                transform_path, skip_rate=settings.camera_skip_rate
            )
    mask_images = None
    if mask_path is not None:
        with log.phase("mask_load"):
            mask_images = load_image_masks(mask_path)
        for name in mask_images:
            if name not in transforms:
                log.warn(f"mask '{name}' has no matching frame in the transforms; "
                         "it will be ignored")

    with log.phase("load_gaussians"):
        gaussians = load_gaussians(
            input_path, max_sh_degree=settings.max_sh_degree,
            compact_colours=settings.render.compact_pairs and settings.render_colours,
            device=device,
        )
    if settings.calculate_normals:
        gaussians = gaussians.calculate_normals()

    contributions = None
    diag = None
    if settings.render_colours:
        if transform_path is None:
            raise ValueError(
                "colour rendering needs camera transforms: pass --transform_path "
                "(or --no_render_colours to skip the sweep)"
            )
        log.info("Camera sweep: rendering per-Gaussian colours")
        with log.phase("render_sweep"):
            cameras = build_camera_batch(
                transforms, intrinsics, colour_resolution=settings.colour_resolution,
                masks=mask_images, device=device,
            )
            acc = run_render_sweep(gaussians, cameras, settings)
        diag = report_truncation(acc)
        with log.phase("cull_chain"):
            gaussians = cull_chain(gaussians, acc, settings)
            kept = int(gaussians.keep_mask.sum())
        log.info(f"Gaussians surviving the cull chain: {kept} of {gaussians.num_gaussians}")
        if kept < 1:
            raise ValueError(
                "every Gaussian was culled; no points can be sampled "
                "(relax the cull thresholds or check the camera poses)"
            )
        if settings.prioritise_visible_gaussians:
            contributions = acc.total_contribution
    else:
        gaussians = dataclasses.replace(gaussians, colours=gaussians.colours * 255.0)
        log.info("Colour sweep disabled; using stored Gaussian colours")

    with log.phase("psd_validate"):
        gaussians = gaussians.validate_covariances()
    with log.phase("point_sampling"):
        cloud = generate_point_cloud(gaussians, settings, contributions=contributions)
    return Conversion(cloud, diag)
