"""Camera sweeps + per-Gaussian accumulators (counterpart of
gs2pc.parallel.sweep): the single-device sweep and the camera
data-parallel sweep, with the tile renderer or the dense oracle.  The
camera split runs as an SPMD program, one process per device combined by
collectives (render_sweep_spmd, the JAX package's shard_map), or from one
thread over a list of devices (render_sweep_sharded, its twin).

  max_contribution      running max of the per-image max alpha*T
  colours               rendered colour at the winning pixel, [0, 1]
  total_contribution    SUM of the per-image max contributions
  min_surface_distance  running min |depth - expected depth|
  n_dropped             summed truncation counters (see RenderOutput)
  k1_work               summed K1 work counters (see RenderOutput)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from gs2pc_torch.camera import CAMERA_TENSORS, CameraBatch
from gs2pc_torch.ops.blend import FLOAT_MAX, RenderOutput
from gs2pc_torch.ops.dense_render import render_dense
from gs2pc_torch.ops.rasterize import TileConfig, render_tile_camera
from gs2pc_torch.ops.sh import view_colours
from gs2pc_torch.parallel.mesh import split_evenly
from gs2pc_torch.utils import log


class RenderArrays(NamedTuple):
    """What the renderer reads of a scene (the JAX package's scene_arrays)."""

    means: torch.Tensor  # (P, 3)
    cov_factors: torch.Tensor  # (P, 3, 3)
    opacities: torch.Tensor  # (P,)
    colours: torch.Tensor  # (P, 3)
    alive: torch.Tensor  # (P,) bool

    def to(self, device) -> "RenderArrays":
        """On ``device``; tensors already there are not copied."""
        return RenderArrays(*(t.to(device) for t in self))


def render_arrays(gaussians) -> RenderArrays:
    return RenderArrays(
        gaussians.xyz, gaussians.covariance_factors(), gaussians.opacities,
        gaussians.colours, gaussians.keep_mask,
    )


def broadcast_sweep_inputs(axis, root=None) -> tuple:
    """Rank 0's ``root`` = (RenderArrays, CameraBatch, SH or None) on every
    rank of ``axis``, each on its rank's device: the scene is parsed once,
    on rank 0, and replicated, as the JAX package parses once and
    replicates.  The other ranks pass nothing."""
    meta = tensors = None
    if axis.rank == 0:
        scene, cams, sh = root
        meta = (cams.widths, cams.heights, cams.width_pad, cams.height_pad,
                None if sh is None else sh.degree)
        tensors = [*scene, *(getattr(cams, f) for f in CAMERA_TENSORS),
                   None if sh is None else sh.coeffs]
    widths, heights, width_pad, height_pad, degree = axis.broadcast_object(meta)
    tensors = axis.broadcast_tensors(tensors)
    n = len(RenderArrays._fields)
    cams = CameraBatch(**dict(zip(CAMERA_TENSORS, tensors[n:-1])), widths=widths,
                       heights=heights, width_pad=width_pad, height_pad=height_pad)
    sh = None if degree is None else SH(tensors[-1], degree)
    return RenderArrays(*tensors[:n]), cams, sh


class SweepAccumulators(NamedTuple):
    max_contribution: torch.Tensor  # (P,)
    colours: torch.Tensor  # (P, 3)
    total_contribution: torch.Tensor  # (P,)
    min_surface_distance: torch.Tensor  # (P,)
    n_dropped: Optional[torch.Tensor] = None  # (4,) float64
    # (3,) float64 K1's work summed over the cameras (RenderOutput.k1_work):
    # the tile renderer's camera sweeps carry it, walked or SPMD; the dense
    # oracle, the depth-slab and 2-D sweeps and a loaded sweep leave None.
    k1_work: Optional[torch.Tensor] = None

    def to(self, device) -> "SweepAccumulators":
        return SweepAccumulators(*(None if t is None else t.to(device) for t in self))


def init_accumulators(num_gaussians: int, *, device) -> SweepAccumulators:
    f32 = dict(dtype=torch.float32, device=device)
    return SweepAccumulators(
        max_contribution=torch.zeros(num_gaussians, **f32),
        colours=torch.zeros((num_gaussians, 3), **f32),
        total_contribution=torch.zeros(num_gaussians, **f32),
        min_surface_distance=torch.full((num_gaussians,), FLOAT_MAX, **f32),
        n_dropped=torch.zeros(4, dtype=torch.float64, device=device),
    )


def _add_counters(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    """Sum of two counter vectors; a side without counters (None: the dense
    oracle's, or accumulators not yet counting) leaves the other as it is."""
    if a is None or b is None:
        return b if a is None else a
    return a + b


def update_accumulators(acc: SweepAccumulators, out: RenderOutput) -> SweepAccumulators:
    """Strict ``>``: on equal contributions the earlier camera keeps its colour."""
    upd = out.contrib > acc.max_contribution
    return SweepAccumulators(
        max_contribution=torch.where(upd, out.contrib, acc.max_contribution),
        colours=torch.where(upd[:, None], out.best_colour, acc.colours),
        total_contribution=acc.total_contribution + out.contrib,
        min_surface_distance=torch.minimum(acc.min_surface_distance, out.surf_dist),
        n_dropped=_add_counters(acc.n_dropped, out.n_dropped),
        k1_work=_add_counters(acc.k1_work, out.k1_work),
    )


def merge_accumulators(a: SweepAccumulators, b: SweepAccumulators) -> SweepAccumulators:
    """Merge the accumulators of two disjoint camera sets, ``b``'s cameras
    after ``a``'s.  Ties keep ``a``: the first-camera-wins rule of
    update_accumulators, so merging consecutive blocks in order gives the
    single sweep's winners exactly."""
    upd = b.max_contribution > a.max_contribution
    return SweepAccumulators(
        max_contribution=torch.where(upd, b.max_contribution, a.max_contribution),
        colours=torch.where(upd[:, None], b.colours, a.colours),
        total_contribution=a.total_contribution + b.total_contribution,
        min_surface_distance=torch.minimum(a.min_surface_distance, b.min_surface_distance),
        n_dropped=_add_counters(a.n_dropped, b.n_dropped),
        k1_work=_add_counters(a.k1_work, b.k1_work),
    )


class SH(NamedTuple):
    """Full SH coefficients (P, 3, (degree + 1)^2) for per-camera colours."""

    coeffs: torch.Tensor
    degree: int

    def to(self, device) -> "SH":
        return SH(self.coeffs.to(device), self.degree)


def render_camera(
    scene: RenderArrays, camera, cfg: TileConfig, renderer: str = "tile",
    calc_surface_distance: bool = True, sh: Optional[SH] = None,
) -> RenderOutput:
    """One camera with ``renderer`` (gs2pc.parallel.sweep._render_one):
    "tile", or "dense", the oracle, in chunks of ``cfg.run_chunk``
    Gaussians with the camera's mask.  With ``sh`` the colours are the
    Gaussians' SH seen from this camera, so each camera blends its own
    colour table."""
    if sh is not None:
        scene = scene._replace(
            colours=view_colours(sh.degree, sh.coeffs, scene.means, camera.campos))
    if renderer == "dense":
        return render_dense(
            *scene, camera, cfg.width_pad, cfg.height_pad, chunk=cfg.run_chunk,
            calc_surface_distance=calc_surface_distance, mask=camera.mask,
        )
    if renderer != "tile":
        raise ValueError(f"unknown renderer {renderer!r} (tile or dense)")
    return render_tile_camera(*scene, camera, cfg, calc_surface_distance=calc_surface_distance)


def render_sweep(
    scene: RenderArrays, cameras, cfg: TileConfig, calc_surface_distance: bool = True,
    renderer: str = "tile", sh: Optional[SH] = None,
) -> SweepAccumulators:
    """Render every camera in turn on the scene's device and fold it into
    the accumulators.  The tile renderer's sweep counts K1's work from zero,
    so every rank of an SPMD sweep holds the counter, cameras or not."""
    acc = init_accumulators(scene.means.shape[0], device=scene.means.device)
    if renderer == "tile":
        acc = acc._replace(k1_work=torch.zeros(3, dtype=torch.float64,
                                               device=scene.means.device))
    for i in range(cameras.num_cameras):
        out = render_camera(scene, cameras.at(i), cfg, renderer, calc_surface_distance, sh)
        acc = update_accumulators(acc, out)
    return acc


def render_sweep_sharded(
    scene: RenderArrays,
    cameras,
    cfg: TileConfig,
    devices: Sequence[torch.device],
    calc_surface_distance: bool = True,
    renderer: str = "tile",
    sh: Optional[SH] = None,
) -> SweepAccumulators:
    """Camera data-parallel sweep (gs2pc.parallel.sweep.render_sweep_sharded).

    Cameras go to the devices in contiguous blocks whose sizes differ by at
    most one (no padded cameras); each device sweeps its block with the
    scene copied to it (no copy where it already lies), and the blocks'
    accumulators merge in order on ``devices[0]``: total summed, surface
    distance min, counters summed, (max, colour) from the first block that
    reaches the max, so the single sweep's first-camera-wins tie-break
    holds.  The devices are walked in turn."""
    acc = init_accumulators(scene.means.shape[0], device=devices[0])
    for dev, (lo, hi) in zip(devices, split_evenly(cameras.num_cameras, len(devices))):
        if hi > lo:
            part = render_sweep(scene.to(dev), cameras.sub(lo, hi, dev), cfg,
                                calc_surface_distance, renderer,
                                None if sh is None else sh.to(dev))
            acc = merge_accumulators(acc, part.to(devices[0]))
    return acc


def gather_merge(acc: SweepAccumulators, axis, blocks) -> SweepAccumulators:
    """Every rank's accumulators gathered over ``axis`` and merged in rank
    order from init_accumulators, skipping the ranks whose camera block
    ``blocks[r]`` is empty: render_sweep_sharded's fold, on every rank.
    A field that is None (the same on every rank) stays None."""
    parts = [None if t is None else axis.all_gather(t) for t in acc]
    out = init_accumulators(acc.max_contribution.shape[0], device=axis.device)
    for r, (lo, hi) in enumerate(blocks):
        if hi > lo:
            out = merge_accumulators(
                out, SweepAccumulators(*(None if p is None else p[r] for p in parts)))
    return out


def render_sweep_spmd(
    scene: RenderArrays,
    cameras,
    cfg: TileConfig,
    axis,
    calc_surface_distance: bool = True,
    renderer: str = "tile",
    sh: Optional[SH] = None,
) -> SweepAccumulators:
    """render_sweep_sharded as one rank of an SPMD program (the JAX
    package's shard_map over the camera axis): rank r of ``axis``
    (gs2pc_torch.parallel.group.Axis) sweeps block r of
    ``split_evenly(N, D)`` with the scene, cameras and SH on its own
    device, then the accumulators are gathered and merged as the walk
    merges them (gather_merge), so every rank returns the walk's
    accumulators bit for bit.  A rank with an empty block takes part in
    every collective."""
    blocks = split_evenly(cameras.num_cameras, axis.size)
    lo, hi = blocks[axis.rank]
    acc = render_sweep(scene, cameras.sub(lo, hi, axis.device), cfg, calc_surface_distance,
                       renderer, sh)
    with log.phase("gather"):
        return gather_merge(acc, axis, blocks)
