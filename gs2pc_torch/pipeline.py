"""End-to-end conversion: load -> camera sweep (on one device, or sharded
over several, one process each; or a saved sweep) -> cull chain -> PSD
clamp -> sample -> a point cloud whose positions stay on the device until
the PLY writer streams them (LazyPointCloud), and with --generate_mesh a
second, surface point cloud (counterpart of
gs2pc.pipeline.convert_3dgs_to_pc).

Culled Gaussians stay in place with keep_mask False and get a zero point
quota, as in the JAX package, so every cull predicate sees the initial set.
A sweep over several devices is an SPMD program over the process's pool
of ranks (gs2pc_torch.parallel.launch, started by the first such
conversion and kept for the next): this process is rank 0, parses the
scene once and broadcasts it, and runs the cull chain and the writer alone.  The sampler's point axis is
split over the same ranks, as the JAX package shards it
(gs2pc/pipeline.py:540-579): rank 0 broadcasts the sampler's inputs, rank r
samples block r of the slots with K5, and rank 0 gathers the blocks.  The
draws are keyed on the global slot (gs2pc_torch.ops.prng), so the split
cloud equals one device's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from gs2pc_torch.utils.config import GaussPointCloudSettings
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.io.colmap import load_transform_data
from gs2pc_torch.io.gaussians_io import load_gaussians
from gs2pc_torch.io.masks import load_image_masks
from gs2pc_torch.io.ply import PointCloud
from gs2pc_torch.meshing_native import MeshResult
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import prng
from gs2pc_torch.ops.blend import FLOAT_MAX
from gs2pc_torch.ops.rasterize import TileConfig
from gs2pc_torch.ops.sampler import (
    SamplerScene,
    distribute_points,
    sample_points,
    slot_prefix,
)
from gs2pc_torch.parallel import launch, mesh
from gs2pc_torch.parallel.gauss_shard import (
    render_sweep_2d,
    render_sweep_2d_spmd,
    render_sweep_gauss_sharded,
    render_sweep_gauss_spmd,
)
from gs2pc_torch.sweep import (
    SH,
    SweepAccumulators,
    broadcast_sweep_inputs,
    render_arrays,
    render_sweep,
    render_sweep_sharded,
    render_sweep_spmd,
)
from gs2pc_torch.utils import log
from gs2pc_torch.utils.checkpoint import load_accumulators, save_accumulators

# Truncation (dropped / blended pairs) above which the capacities are
# reported as degrading quality, and --auto_capacity re-renders.
TRUNCATION_WARN_FRACTION = 0.005
AUTO_CAPACITY_ATTEMPTS = 3
# Surface points per surface Gaussian for the mesh cloud (the reference's
# gauss_to_pc.py:575).
AVG_POINTS_PER_GAUSS_FOR_MESH = 25


class LazyPointCloud:
    """A point cloud whose positions stay on the device after sampling
    (gs2pc.pipeline.LazyPointCloud): the PLY writer pulls them to the host
    a chunk at a time (``point_rows`` / ``stream_chunks``), the next chunk's
    copy in flight while the current one is packed and written.  Colours
    and normals stay per-Gaussian host planes that expand over ``counts``
    (points are slot-major, so they are row repeats).

    A drop-in for io.ply.PointCloud: ``total``, ``counts``, ``cols_u8``,
    ``gauss_normals``, ``gauss_ids()``, ``normals``, and ``points``, which
    copies the positions to the host once and keeps them.  ``device_points``
    holds them on their device, (total, 3) float32."""

    def __init__(self, points: torch.Tensor, counts: np.ndarray, cols_u8: np.ndarray,
                 gauss_normals: Optional[np.ndarray], total: int):
        """``points``: (m, 3) float32 on its device, m >= ``total``, made on
        that device's current stream (which the copies wait for)."""
        if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3:
            raise ValueError("points must be an (m, 3) float32 tensor")
        if points.shape[0] < total:
            raise ValueError(f"{points.shape[0]} point rows for a cloud of {total}")
        self.device_points = points[:total].contiguous()
        self.counts = counts
        self.cols_u8 = cols_u8
        self.gauss_normals = gauss_normals
        self.total = int(total)
        self._stream = (torch.cuda.current_stream(points.device)
                        if points.device.type == "cuda" else None)
        self._copy_stream = None
        self._points = None

    def gauss_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.counts.shape[0], dtype=np.int64), self.counts)

    @property
    def normals(self) -> Optional[np.ndarray]:
        if self.gauss_normals is None:
            return None
        return self.gauss_normals[self.gauss_ids()]

    @property
    def points(self) -> np.ndarray:
        if self._points is None:
            if self._stream is None:
                self._points = self.device_points.numpy()
            else:
                with torch.cuda.stream(self._stream):
                    self._points = self.device_points.cpu().numpy()
        return self._points

    def point_rows(self, chunk_rows: int = 10**6):
        """Yield (lo, rows lo..lo+n-1 as an (n, 3) float32 array) in order.

        On a card the rows come through two pinned host buffers on a side
        stream (one a cloud) that waits for the stream that made the points:
        chunk k + 1's copy is issued into the other buffer before chunk k is
        yielded, so it runs while the consumer works on chunk k, and a buffer
        is refilled only after the consumer has returned from the chunk that
        used it.  A chunk's array is therefore valid only until the next one
        is asked for.  On the CPU the chunks are slices of the points."""
        total = self.total
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        bounds = [(lo, min(lo + chunk_rows, total)) for lo in range(0, total, chunk_rows)]
        src = self.device_points
        if self._stream is None:
            def issue(k):
                lo, hi = bounds[k]
                return lambda: src[lo:hi].numpy()
        else:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(src.device)
            side = self._copy_stream
            side.wait_stream(self._stream)
            rows = min(chunk_rows, total)
            bufs = [torch.empty((rows, 3), dtype=torch.float32, pin_memory=True)
                    for _ in range(min(2, len(bounds)))]

            def issue(k):
                lo, hi = bounds[k]
                buf = bufs[k % 2][:hi - lo]
                with torch.cuda.stream(side):
                    buf.copy_(src[lo:hi], non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)

                def wait():
                    done.synchronize()
                    return buf.numpy()
                return wait
        try:
            pending = issue(0) if bounds else None
            for k, (lo, _) in enumerate(bounds):
                ahead = issue(k + 1) if k + 1 < len(bounds) else None
                yield lo, pending()
                pending = ahead
        finally:
            if self._copy_stream is not None:
                self._copy_stream.synchronize()

    def stream_chunks(self, chunk_rows: int = 10**6):
        """Yield (points (n, 3) float32, colours (n, 3) uint8, normals (n, 3)
        float32 or None) in chunk order (point_rows' chunks, whose points
        are valid only until the next chunk is asked for)."""
        gid = self.gauss_ids()
        for lo, pts in self.point_rows(chunk_rows):
            g = gid[lo:lo + pts.shape[0]]
            yield (pts, self.cols_u8[g],
                   None if self.gauss_normals is None else self.gauss_normals[g])


def set_precision() -> None:
    """Full float32 products: TF32 keeps ~3 decimal digits, the GPU form of
    the bf16 trap the JAX package hit in its K=3 geometry (DESIGN §7b)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def report_truncation(acc: SweepAccumulators) -> Optional[list]:
    """Log the sweep's truncation counters and return them, with K1's three
    work counters appended where the sweep counted them (Conversion.
    sweep_diag), or None for a sweep without counters (one loaded from a
    checkpoint).  The pair expansion is exact, so only the per-tile run cap
    can drop pairs (and the depth-slab buffers, counted as window drops)."""
    if acc.n_dropped is None:
        return None
    counters = acc.n_dropped if acc.k1_work is None else torch.cat([acc.n_dropped, acc.k1_work])
    diag = [float(x) for x in counters.cpu()]
    pairs, win_drop, cap_drop, cap_live = diag[:4]
    if pairs == 0.0 and win_drop == 0.0 and cap_drop == 0.0:
        return diag
    log.info(
        f"Render pairs: {pairs:,.0f} blended; {win_drop:,.0f} dropped with "
        f"full slab buffers; {cap_drop:,.0f} beyond the per-tile cap "
        f"({cap_live:,.0f} on live tiles)"
    )
    win_material, cap_material = truncation_material(diag)
    if win_material:
        log.warn(
            f"{win_drop:,.0f} Gaussians ({100.0 * win_drop / max(pairs, 1.0):.2f}% of "
            "blended pairs) did not fit their depth-slab buffers"
        )
    if cap_material:
        log.warn(
            f"{cap_live:,.0f} pairs ({100.0 * cap_live / max(pairs, 1.0):.2f}% of "
            "blended) fell beyond the per-tile depth cap on tiles with visible "
            "transmittance; raise --max_pairs_per_tile (or pass --auto_capacity)"
        )
    return diag


def truncation_material(diag: Optional[list]) -> tuple[bool, bool]:
    """(window drops material, live run-cap drops material) of a sweep's
    counters: each above TRUNCATION_WARN_FRACTION of the blended pairs
    (gs2pc.pipeline.report_truncation's flags)."""
    if diag is None:
        return False, False
    pairs, win_drop, cap_drop, cap_live = diag[:4]
    if pairs == 0.0 and win_drop == 0.0 and cap_drop == 0.0:
        return False, False
    denom = max(pairs, 1.0)
    return (win_drop / denom > TRUNCATION_WARN_FRACTION,
            cap_live / denom > TRUNCATION_WARN_FRACTION)


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


class SamplingJob(NamedTuple):
    """One sampling's settings, as rank 0 sends them to the other ranks."""

    key: list  # the two words of prng.PRNGKey(seed)
    n_cap: int
    std: float
    max_points: Optional[int]


def sample_on_axis(axis, job: SamplingJob, root=None, prefix=None) -> Optional[torch.Tensor]:
    """One sampling split over the ranks of ``axis`` (a rank function of
    gs2pc_torch.parallel.launch.run): rank 0's ``root`` = (quotas, xyz,
    log_scales, rots) broadcast, rank r samples block r of
    mesh.split_evenly(n, ranks) with K5, and rank 0 gathers the blocks in
    rank order.  Rank 0 gets the (n, 3) points, the others None.  Each step
    is a phase (sample_broadcast, sample_block, sample_gather), summed over
    a conversion's samplings.  ``prefix``: rank 0's slot_prefix of the
    quotas, which the other ranks compute from theirs."""
    with log.phase("sample_broadcast"):
        ppg, xyz, log_scales, rots = axis.broadcast_tensors(root)
    with log.phase("sample_block"):
        if prefix is None:
            prefix = slot_prefix(ppg, job.n_cap, job.max_points)
        blocks = mesh.split_evenly(prefix[1], axis.size)
        part = sample_points(
            torch.tensor(job.key), SamplerScene(xyz, log_scales, rots), ppg, job.n_cap,
            job.std, job.max_points, block=blocks[axis.rank], prefix=prefix,
        ).points
    with log.phase("sample_gather"):
        return axis.gather_blocks(part, [hi - lo for lo, hi in blocks])


def serve_samplings(axis) -> None:
    """A rank other than 0 of an SPMD conversion, after the sweep: its block
    of every sampling rank 0 starts (generate_point_cloud), until rank 0
    sends the end (None)."""
    while (job := axis.broadcast_object()) is not None:
        sample_on_axis(axis, job)


def generate_point_cloud(
    gaussians: Gaussians,
    settings: GaussPointCloudSettings,
    contributions: Optional[torch.Tensor] = None,
    num_points: Optional[int] = None,
    seed_offset: int = 0,
    axis=None,
) -> LazyPointCloud:
    """Quotas -> sampled positions -> a point cloud whose positions stay on
    the device until it is written (LazyPointCloud), for ``num_points``
    (default ``settings.num_points``) drawn with JAX's key
    ``PRNGKey(settings.seed + seed_offset)`` (gs2pc/pipeline.py:589).  On
    rank 0 of an SPMD ``axis`` the slots are split over its ranks
    (sample_on_axis; the others run serve_samplings).  The quotas' slot
    prefix is computed once and serves the sampler and the counts."""
    if num_points is None:
        num_points = settings.num_points
    sizes = gaussians.magnitudes(contributions=contributions)
    sizes = torch.where(gaussians.keep_mask, sizes, 0.0)
    ppg = distribute_points(
        sizes, num_points, mask=gaussians.keep_mask, exact=settings.exact_num_points
    )
    job = SamplingJob(
        key=prng.PRNGKey(settings.seed + seed_offset).tolist(),
        n_cap=int(num_points + max(4096, num_points // 20)),
        std=settings.mahalanobis_distance_std,
        max_points=num_points if settings.exact_num_points else None,
    )
    prefix, n = slot_prefix(ppg, job.n_cap, job.max_points)
    if axis is None:
        points = sample_points(torch.tensor(job.key), gaussians, ppg, job.n_cap, job.std,
                               job.max_points, prefix=(prefix, n)).points
    else:
        axis.broadcast_object(job)
        points = sample_on_axis(axis, job, (ppg, gaussians.xyz, gaussians.log_scales,
                                            gaussians.rots), prefix=(prefix, n))
    # Points per Gaussian: the quotas, the tail runs trimmed where n_cap /
    # max_points cut them.
    counts = torch.diff(torch.clamp(prefix, max=n), prepend=prefix.new_zeros(1))
    cols_u8 = torch.clamp(gaussians.colours, 0.0, 255.0).to(torch.uint8)
    return LazyPointCloud(
        points, counts.cpu().numpy(), cols_u8.cpu().numpy(),
        None if gaussians.normals is None else gaussians.normals.cpu().numpy(), n,
    )


class Conversion(NamedTuple):
    # A LazyPointCloud; an io.ply.PointCloud once --clean_pointcloud ran.
    cloud: Union[LazyPointCloud, PointCloud]
    # Summed sweep counters [pairs blended, window-truncated, run-cap
    # dropped, run-cap dropped on live tiles], then, where the sweep counted
    # K1's work (the tile renderer's camera sweeps), [pairs K1 streamed,
    # pairs its surface pass streamed, padded pixels] summed over the
    # cameras; None without a sweep or with a loaded one.  Readers of the
    # truncation counters take sweep_diag[:4].
    sweep_diag: Optional[list]
    # Which PLY writer ran (io.ply.save_point_cloud_ply: "native_stream" for
    # a lazy cloud, "native_expand" for an eager one), once the CLI wrote.
    writer: Optional[str] = None
    # With --generate_mesh: the surface point cloud, and (surface
    # Gaussians, the points asked of them).
    surface_cloud: Optional[LazyPointCloud] = None
    surface_quota: Optional[tuple] = None
    # The mesh, once the CLI built it.
    mesh: Optional[MeshResult] = None


def resolve_num_devices(num_devices: int, settings: GaussPointCloudSettings, device):
    """The --num_devices contract: 0 means every local card of ``device``'s
    type (one for the CPU).  When that resolves to one device, a sharded
    --shard_axis falls back to the single-device sweep with a warning; an
    EXPLICIT --num_devices 1 with a sharded axis raises in run_render_sweep
    instead, since ignoring an explicit request would hide a mistake."""
    if num_devices == 0:
        num_devices = torch.cuda.device_count() if device.type == "cuda" else 1
        if num_devices == 1 and settings.shard_axis != "cams":
            log.warn(f"--shard_axis {settings.shard_axis} ignored: only one local device")
            settings = settings._replace(shard_axis="cams")
    return num_devices, settings


def sweep_devices(device: torch.device, num_devices: int) -> list:
    """The sweep's devices: ``device`` alone; for a CUDA ``device``, N cards
    with ``device`` first, then the lowest-numbered others (raising if the
    machine has fewer), since the first is rank 0 of an SPMD sweep, which
    runs the rest of the conversion; or N times the CPU."""
    if num_devices == 1:
        return [device]
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh.devices(num_devices)  # raises when the machine has fewer
        others = [c for c in mesh.devices(torch.cuda.device_count()) if c != device]
        return [device] + others[:num_devices - 1]
    return [device] * num_devices


def _check_split(settings, n_devices: int) -> None:
    """Raise on a --shard_axis the devices or the renderer cannot take."""
    if settings.shard_axis != "cams" and n_devices <= 1:
        raise ValueError(
            f"--shard_axis {settings.shard_axis} needs --num_devices > 1 "
            "(it would otherwise be silently ignored)"
        )
    if settings.shard_axis != "cams" and settings.renderer_type != "tile":
        raise ValueError(f"--shard_axis {settings.shard_axis} requires the tile renderer")


def _sweep_plan(cameras, settings) -> tuple:
    """(TileConfig, surface pass on) of a sweep.  The mesh cloud samples the
    surface Gaussians, so meshing needs the surface distances too."""
    cfg = tile_config(settings, cameras.width_pad, cameras.height_pad)
    return cfg, settings.surface_distance_std is not None or settings.generate_mesh


def _sweep_sh(gaussians, settings) -> Optional[SH]:
    """The SH the sweep evaluates per camera (--sh_colour_eval), or None."""
    if settings.sh_colour_eval and gaussians.shs is not None:
        return SH(gaussians.shs, settings.max_sh_degree)
    return None


def run_render_sweep(
    gaussians, cameras, settings, devices: Optional[Sequence[torch.device]] = None
) -> SweepAccumulators:
    """The camera sweep over ``devices`` (default: the scene's device) on the
    axis ``settings.shard_axis`` names, several devices walked in turn from
    this thread (the SPMD sweeps' twins, run_render_sweep_spmd);
    accumulators on ``devices[0]``."""
    devices = list(devices) if devices is not None else [gaussians.device]
    _check_split(settings, len(devices))
    cfg, csd = _sweep_plan(cameras, settings)
    scene = render_arrays(gaussians)
    sh = _sweep_sh(gaussians, settings)
    if settings.shard_axis == "gauss":
        return render_sweep_gauss_sharded(scene, cameras, cfg, devices, calc_surface_distance=csd,
                                          sh=sh)
    if settings.shard_axis == "both":
        return render_sweep_2d(scene, cameras, cfg, devices, calc_surface_distance=csd, sh=sh)
    if len(devices) > 1:
        return render_sweep_sharded(scene, cameras, cfg, devices, calc_surface_distance=csd,
                                    renderer=settings.renderer_type, sh=sh)
    return render_sweep(scene, cameras, cfg, calc_surface_distance=csd,
                        renderer=settings.renderer_type, sh=sh)


def run_render_sweep_spmd(axis, scene, cameras, settings, sh=None) -> Optional[SweepAccumulators]:
    """run_render_sweep as one rank of an SPMD program over ``axis``
    (gs2pc_torch.parallel.group.Axis), with the scene, cameras and SH on
    this rank's device; the accumulators on rank 0 (None on the 2-D
    split's ranks that hold no merged result)."""
    _check_split(settings, axis.size)
    cfg, csd = _sweep_plan(cameras, settings)
    if settings.shard_axis == "gauss":
        return render_sweep_gauss_spmd(scene, cameras, cfg, axis, calc_surface_distance=csd,
                                       sh=sh)
    if settings.shard_axis == "both":
        return render_sweep_2d_spmd(scene, cameras, cfg, axis, calc_surface_distance=csd, sh=sh)
    return render_sweep_spmd(scene, cameras, cfg, axis, calc_surface_distance=csd,
                             renderer=settings.renderer_type, sh=sh)


def _with_capacity(settings, sweep, axis=None):
    """``sweep(settings)``, and with --auto_capacity up to two re-renders,
    each with the run cap doubled, while the live run-cap drops are
    material (gs2pc/pipeline.py's escalation; the port expands pairs
    exactly and has no pair budget, so the run cap is the one capacity to
    grow).  Over an SPMD ``axis`` rank 0 reads the counters and broadcasts
    whether to sweep again, so every rank sweeps as often; only rank 0
    logs.  Returns the last sweep's accumulators and rank 0's counters."""
    lead = axis is None or axis.rank == 0
    attempts = AUTO_CAPACITY_ATTEMPTS if settings.auto_capacity else 1
    for attempt in range(attempts):
        acc = sweep(settings)
        diag = report_truncation(acc) if lead else None
        again = attempt < attempts - 1 and truncation_material(diag)[1]
        if axis is not None and attempts > 1:
            again = axis.broadcast_object(again)
        if not again:
            return acc, diag
        run_cap = settings.render.max_pairs_per_tile * 2
        settings = settings._replace(
            render=settings.render._replace(max_pairs_per_tile=run_cap))
        if lead:
            log.warn(f"auto_capacity: re-rendering with run_cap={run_cap}")


def sweep_with_capacity(gaussians, cameras, settings, devices):
    """run_render_sweep over ``devices`` with --auto_capacity's re-renders
    (_with_capacity); accumulators on ``devices[0]``, and their counters."""
    return _with_capacity(settings, lambda s: run_render_sweep(gaussians, cameras, s, devices))


def sweep_with_capacity_spmd(axis, gaussians, cameras, settings):
    """sweep_with_capacity as one rank of an SPMD program: rank 0's scene,
    cameras and SH broadcast to every rank (the other ranks pass None for
    ``gaussians`` and ``cameras``), then run_render_sweep_spmd with
    --auto_capacity's re-renders.  Rank 0 gets the accumulators and their
    counters."""
    root = None
    if axis.rank == 0:
        root = (render_arrays(gaussians), cameras, _sweep_sh(gaussians, settings))
    with log.phase("scene_broadcast"):
        scene, cams, sh = broadcast_sweep_inputs(axis, root)
    with log.phase("sweep"):
        return _with_capacity(
            settings, lambda s: run_render_sweep_spmd(axis, scene, cams, s, sh), axis)


def convert_3dgs_to_pc(
    input_path: str,
    transform_path: Optional[str],
    mask_path: Optional[str],
    settings: GaussPointCloudSettings,
    *,
    device,
    num_devices: int = 1,
) -> Conversion:
    """The full conversion on ``device``, with the camera sweep over
    ``num_devices`` devices (0: every local card; see resolve_num_devices
    and sweep_devices; 1 by default, as in the JAX package's library, while
    the CLI's --num_devices defaults to 0), or the sweep loaded from
    ``settings.load_sweep`` (then no transforms are needed); returns the
    point cloud (LazyPointCloud), and the surface point cloud with --generate_mesh.

    A sweep over several devices runs as an SPMD program, one process per
    device (gs2pc_torch.parallel.launch; this process is rank 0 on
    ``device``, convert_rank): the ranks share the sweep and the samplings,
    rank 0 alone runs the rest; a failed rank fails the conversion.  The
    ranks are the process's pool (launch.run): the first such conversion
    starts them, and later ones on the same devices hand their job to the
    same ranks.
    A conversion with no sweep (--load_sweep, --no_render_colours) or on
    one device samples on ``device``, with the same values."""
    device, settings, devices = _conversion_devices(settings, device, num_devices)
    sweeps = settings.render_colours and settings.load_sweep is None
    if len(devices) > 1 and sweeps:
        _check_split(settings, len(devices))
        return launch.run(convert_rank, devices, input_path, transform_path, mask_path,
                          settings)
    return _convert(input_path, transform_path, mask_path, settings, device,
                    lambda g, cams, s: sweep_with_capacity(g, cams, s, devices))


def _convert_walked(input_path, transform_path, mask_path, settings, *, device,
                    num_devices: int = 1, devices: Optional[Sequence] = None) -> Conversion:
    """convert_3dgs_to_pc with its sweep over several devices walked in turn
    from this thread and its samplings on ``device``: the SPMD conversion's
    twin, which the checks hold it to.  ``devices`` replaces the sweep's
    devices (a device may repeat: [cuda:0] * 2 stands for two cards)."""
    device, settings, found = _conversion_devices(settings, device, num_devices)
    devices = found if devices is None else list(devices)
    return _convert(input_path, transform_path, mask_path, settings, device,
                    lambda g, cams, s: sweep_with_capacity(g, cams, s, devices))


def _conversion_devices(settings, device, num_devices: int) -> tuple:
    """(device, settings, sweep devices) of a conversion, with its
    precision and logging set."""
    set_precision()
    device = torch.device(device)
    log.set_quiet(settings.quiet)
    num_devices, settings = resolve_num_devices(num_devices, settings, device)
    return device, settings, sweep_devices(device, num_devices)


def convert_rank(axis, input_path, transform_path, mask_path, settings, root=None):
    """The SPMD conversion's rank function (gs2pc_torch.parallel.launch.run):
    rank 0 runs the whole conversion on its device with the sweep and the
    samplings shared over ``axis``; the other ranks take part in the sweep
    and sample their blocks.  A rank 0 that raises before it ends the
    samplings fails the run (launch.run stops the waiting ranks)."""
    set_precision()
    if axis.rank > 0:
        sweep_with_capacity_spmd(axis, None, None, settings)
        serve_samplings(axis)
        return None
    result = _convert(input_path, transform_path, mask_path, settings, axis.device,
                      lambda g, cams, s: sweep_with_capacity_spmd(axis, g, cams, s), axis)
    axis.broadcast_object(None)
    return result


def _convert(input_path, transform_path, mask_path, settings, device, sweep,
             axis=None) -> Conversion:
    """convert_3dgs_to_pc on ``device`` with ``sweep(gaussians, cameras,
    settings) -> (accumulators, counters)``, the samplings split over the
    SPMD ``axis`` when one is given (rank 0's side)."""
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
        # 8-bit colours exactly where the blend quantises them anyway: the
        # tile renderer's compact tables.
        gaussians = load_gaussians(
            input_path, max_sh_degree=settings.max_sh_degree,
            compact_colours=(settings.render.compact_pairs and settings.renderer_type == "tile"
                             and settings.render_colours),
            with_shs=settings.sh_colour_eval, device=device,
        )
    if settings.calculate_normals:
        gaussians = gaussians.calculate_normals()

    contributions = None
    diag = None
    surface_keep = None
    if settings.render_colours:
        if transform_path is None and settings.load_sweep is None:
            raise ValueError(
                "colour rendering needs camera transforms: pass --transform_path "
                "(or --no_render_colours to skip the sweep)"
            )
        if settings.load_sweep is not None:
            with log.phase("load_sweep"):
                acc = load_accumulators(settings.load_sweep, gaussians.num_gaussians,
                                        scene_xyz=gaussians.xyz, device=device)
        else:
            log.info("Camera sweep: rendering per-Gaussian colours")
            with log.phase("render_sweep"):
                cameras = build_camera_batch(
                    transforms, intrinsics, colour_resolution=settings.colour_resolution,
                    masks=mask_images, device=device,
                )
                acc, diag = sweep(gaussians, cameras, settings)
                acc = acc.to(device)
            if settings.save_sweep is not None:
                with log.phase("save_sweep"):
                    save_accumulators(settings.save_sweep, acc, gaussians.num_gaussians,
                                      scene_xyz=gaussians.xyz)
        with log.phase("cull_chain"):
            gaussians = cull_chain(gaussians, acc, settings)
            kept = int(gaussians.keep_mask.sum())
        log.info(f"Gaussians surviving the cull chain: {kept} of {gaussians.num_gaussians}")
        if kept < 1:
            raise ValueError(
                "every Gaussian was culled; no points can be sampled "
                "(relax the cull thresholds or check the camera poses)"
            )
        if settings.generate_mesh:
            surface_keep = surface_keep_mask(acc.min_surface_distance, 1.0)
        if settings.prioritise_visible_gaussians:
            contributions = acc.total_contribution
    else:
        gaussians = dataclasses.replace(gaussians, colours=gaussians.colours * 255.0)
        log.info("Colour sweep disabled; using stored Gaussian colours")

    with log.phase("psd_validate"):
        gaussians = gaussians.validate_covariances()
    with log.phase("point_sampling"):
        cloud = generate_point_cloud(gaussians, settings, contributions=contributions,
                                     axis=axis)
    if surface_keep is None:
        return Conversion(cloud, diag)

    # The mesh's point cloud: the surface Gaussians alone, 25 points each
    # at most, drawn with the key of seed + 1.
    surface = gaussians.add_to_cull(surface_keep)
    n_surface = int(surface.keep_mask.sum())
    n_mesh = min(settings.num_points // 2, n_surface * AVG_POINTS_PER_GAUSS_FOR_MESH)
    log.info(f"Sampling the surface (mesh) point cloud: {n_mesh} points over "
             f"{n_surface} surface Gaussians")
    with log.phase("surface_sampling"):
        surface_cloud = generate_point_cloud(surface, settings, contributions=contributions,
                                             num_points=n_mesh, seed_offset=1, axis=axis)
    return Conversion(cloud, diag, surface_cloud=surface_cloud,
                      surface_quota=(n_surface, n_mesh))
