"""Gaussian-axis (depth-slab) sharded renderer (counterpart of
gs2pc.parallel.gauss_shard).

Alpha compositing is associative over depth-ordered segments,

    (C1, T1) (+) (C2, T2) = (C1 + T1 * C2,  T1 * T2),

so each device composites one contiguous DEPTH SLAB of the scene and the
slabs combine with a handful of reductions.  Per camera, on device d of D
(scene on every device):

 1. slab assignment: depth quantile boundaries from a strided sample of
    in-front view depths, computed identically for every device, ties kept
    in one slab; each device compacts its slab to at most
    ``slab_capacity(P, D)`` Gaussians (~1.25 P/D), so projection, pair
    expansion and the sort scale ~1/D;
 2. pass 1: trigger-free alpha product over the slab (K1 with
    ``early_stop=False``) -> per-pixel slab transmittance T_d;
 3. the T_d are gathered; exclusive prefix t0_d = prod_{d' < d} T_d' and
    the global product;
 4. pass 2: full blend with ``init_trans=t0_d`` -> absolute colour / depth
    contributions and per-Gaussian max contribution and best pixel (a pixel
    whose upstream product is already below 1e-4 stops at once, which
    reproduces the single-device stop);
 5. combine: image / expected depth / inverse depth summed, the white
    background added once from the global product; max contribution max;
    best colour gathered from the COMBINED image at each slab's best pixel;
 6. pass 3 (surface pass on): the surface sweep against the combined
    expected-depth map (``surface_ed_override``), min over slabs.

The JAX package runs this as one SPMD program; so does the port.  In
``render_sweep_gauss_spmd`` and ``render_sweep_2d_spmd`` each device is one
process (gs2pc_torch.parallel.launch) that renders its own slab, and each
of the JAX package's collectives is one of its gs2pc_torch.parallel.group.
Axis: ``all_gather`` of the T_d, ``psum`` of the image, depths, best colour
and counters, ``pmax`` of the contribution, ``pmin`` of the surface
distance.  The one-thread walks ``render_sweep_gauss_sharded`` and
``render_sweep_2d`` are their twins: ``all_gather`` is a ``torch.stack`` of
copies to ``devices[0]``, ``psum`` / ``pmax`` / ``pmin`` are ``sum`` /
``amax`` / ``amin`` over that stack, and each result is copied back to a
device where its next pass needs it.  The SPMD sweeps reduce with the
walks' expressions, so the two agree bit for bit.  A device may repeat: on
one card, ``[cuda:0] * 4`` runs four slabs (one scene in the walk, one a
process in SPMD).

Known divergences from the single-device renderer, as in the JAX package:
(a) the background on early-stopped pixels uses the trigger-free product,
which differs from the stopped value by less than 1e-4; (b) the per-tile
``run_cap`` applies per SLAB, so a tile that saturates it blends up to
D x run_cap pairs, more of the scene than one device keeps.  Slab-buffer
overflow (Gaussians past the slack, dropped for that camera) is counted
in ``n_dropped[1]``.  The port has no pair budget, so the JAX package's
divergence (c) does not arise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from gs2pc_torch.ops.blend import FLOAT_MAX, RenderOutput
from gs2pc_torch.ops.linalg3 import dotrow3
from gs2pc_torch.ops.projection import NEAR_Z
from gs2pc_torch.ops.rasterize import TileConfig, render_tile_camera
from gs2pc_torch.ops.sh import view_colours
from gs2pc_torch.parallel.mesh import split_evenly
from gs2pc_torch.sweep import (
    SH,
    RenderArrays,
    SweepAccumulators,
    gather_merge,
    init_accumulators,
    merge_accumulators,
    update_accumulators,
)
from gs2pc_torch.utils import log

_SLAB_SAMPLE = 4096  # strided depth sample for quantile boundaries


def _slab_mask(means, viewmatrix, alive, d: int, n_dev: int) -> torch.Tensor:
    """Deterministic depth-slab assignment (identical for every device)."""
    # preprocess()'s depth expression, so the assignment agrees with the
    # depths the passes sort by, bit for bit.
    depth = dotrow3(means, viewmatrix[2, :3], viewmatrix[2, 3])
    assignable = alive & (depth > NEAR_Z)
    if n_dev == 1:
        return assignable
    stride = max(means.shape[0] // _SLAB_SAMPLE, 1)
    samp = torch.where(assignable[::stride], depth[::stride], FLOAT_MAX)
    samp_sorted = torch.sort(samp).values
    n_ok = (samp < FLOAT_MAX).sum()
    qidx = (n_ok * torch.arange(1, n_dev, device=means.device)) // n_dev
    bounds = samp_sorted[torch.clamp(qidx, 0, samp.shape[0] - 1)]
    # right=True: Gaussians exactly on a boundary all land in the same
    # slab, so equal depths never straddle a device split.
    slab = torch.searchsorted(bounds, depth, right=True)
    return assignable & (slab == d)


def slab_capacity(p: int, n_dev: int, slack: float = 1.25) -> int:
    """Per-device slab buffer size: ~P/D with 25% quantile-error slack,
    rounded to a multiple of 256, capped at P."""
    base = -(-p // max(n_dev, 1))
    cap = int(base * slack) + 256
    return min(-(-cap // 256) * 256, p)


class _Slab(NamedTuple):
    idx: torch.Tensor  # (n,) int64 full-axis ids of the slab's Gaussians
    scene: RenderArrays  # the slab's rows, all alive
    overflow: int  # slab Gaussians beyond slab_capacity, dropped this camera


def _compact(scene: RenderArrays, camera, d: int, n_dev: int, sh: Optional[SH]) -> _Slab:
    """Slab d's rows; with ``sh`` their colours are the SH seen from this
    camera, evaluated on the slab only."""
    p_full = scene.means.shape[0]
    idx = torch.nonzero(_slab_mask(scene.means, camera.viewmatrix, scene.alive, d, n_dev))[:, 0]
    p_slab = slab_capacity(p_full, n_dev)
    overflow = max(idx.shape[0] - p_slab, 0)
    idx = idx[:p_slab]
    rows = [t[idx] for t in scene[:4]]
    if sh is not None:
        rows[3] = view_colours(sh.degree, sh.coeffs[idx], rows[0], camera.campos)
    alive = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    return _Slab(idx, RenderArrays(*rows, alive), overflow)


def _to_full(v: torch.Tensor, idx: torch.Tensor, p_full: int, fill: float) -> torch.Tensor:
    """(n[, k]) slab values -> (P[, k]) full axis (idx is unique)."""
    full = v.new_full((p_full,) + v.shape[1:], fill)
    full[idx] = v
    return full


class _Walked:
    """The slab axis walked from one thread: every slab is rendered here,
    slab d on ``devices[d]``; a collective stacks the slabs' parts on
    ``devices[0]`` and reduces them there."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.size = len(self.devices)
        self.home = self.devices[0]
        self.slabs = range(self.size)  # the slabs rendered here

    def device(self, d: int) -> torch.device:
        return self.devices[d]

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack([p.to(self.home) for p in parts])

    def psum(self, parts):
        return self.all_gather(parts).sum(dim=0)

    def pmax(self, parts):
        return self.all_gather(parts).amax(dim=0)

    def pmin(self, parts):
        return self.all_gather(parts).amin(dim=0)


class _OnAxis:
    """Slab ``axis.rank`` of an SPMD program: this rank renders its own
    slab, and a collective is the axis's (gs2pc_torch.parallel.group.Axis,
    whose reductions are _Walked's expressions over the gathered parts)."""

    def __init__(self, axis):
        self.axis = axis
        self.size = axis.size
        self.home = axis.device
        self.slabs = [axis.rank]

    def device(self, d: int) -> torch.device:
        return self.axis.device

    def all_gather(self, parts):
        return self.axis.all_gather(*parts)

    def psum(self, parts):
        return self.axis.psum(*parts)

    def pmax(self, parts):
        return self.axis.pmax(*parts)

    def pmin(self, parts):
        return self.axis.pmin(*parts)


def _render_one_slabs(
    scenes: Sequence[RenderArrays],
    camera,
    on,
    cfg: TileConfig,
    calc_surface_distance: bool,
    shs: Sequence[Optional[SH]],
) -> RenderOutput:
    """One camera's slab passes (the module docstring's steps 1-6) for the
    slabs ``on.slabs`` (every slab in a walk, one in an SPMD rank), combined
    through ``on``'s collectives; ``scenes[i]`` and ``shs[i]`` are the copies
    on slab ``on.slabs[i]``'s device.  Every value a later pass reads (t0_d,
    the combined image and expected depth) comes out the same on every
    rank, since each gathers the same parts and reduces them alike."""
    mine = list(on.slabs)
    p_full = scenes[0].means.shape[0]
    cams = [camera.to(on.device(d)) for d in mine]
    slabs = [_compact(scenes[i], cams[i], d, on.size, shs[i]) for i, d in enumerate(mine)]

    def render(i, **kw):
        return render_tile_camera(*slabs[i].scene, cams[i], cfg, white_bkgd=False, **kw)

    # Pass 1: trigger-free slab transmittance.
    all_t = on.all_gather([
        render(i, calc_surface_distance=False, early_stop=False, want_trans=True)
        .trans.reshape(-1)
        for i in range(len(mine))
    ])  # (D, Hp * Wp)
    ids = torch.arange(on.size, device=all_t.device)
    t0 = [torch.prod(torch.where((ids < d)[:, None], all_t, 1.0), dim=0).to(on.device(d))
          for d in mine]
    t_global = torch.prod(all_t, dim=0)

    # Pass 2: absolute contributions with the upstream prefix.
    p2 = [render(i, calc_surface_distance=False, init_trans=t0[i], want_best_pix=True)
          for i in range(len(mine))]
    image = on.psum([o.image for o in p2])
    image = image + t_global.reshape(image.shape[:2])[..., None]  # white background
    ed = on.psum([o.depth for o in p2])
    einv = on.psum([o.invdepth for o in p2])
    contrib = on.pmax([_to_full(o.contrib, s.idx, p_full, 0.0) for o, s in zip(p2, slabs)])

    # Colour at the best pixel comes from the COMBINED image; each Gaussian
    # lies in one slab, so one row per Gaussian is non-zero in the sum.
    best = []
    for d, o, s in zip(mine, p2, slabs):
        flat = image.reshape(-1, 3).to(on.device(d))
        rows = torch.where((o.contrib > 0.0)[:, None], flat[o.best_pix], 0.0)
        best.append(_to_full(rows, s.idx, p_full, 0.0))
    best_colour = on.psum(best)

    if calc_surface_distance:
        # Pass 3: the surface sweep against the combined expected depth.
        ed_flat = ed.reshape(-1)
        surf = on.pmin([
            _to_full(
                render(i, calc_surface_distance=True, init_trans=t0[i],
                       surface_ed_override=ed_flat.to(on.device(d))).surf_dist,
                slabs[i].idx, p_full, FLOAT_MAX,
            )
            for i, d in enumerate(mine)
        ])
    else:
        surf = torch.full((p_full,), FLOAT_MAX, device=on.home)

    # Each slab counted its own pairs (the run cap applies per slab, the
    # module docstring's divergence (b)); slab overflow joins the slab's
    # window-truncation counter before the sum: whole numbers in float64,
    # so the sum is exact in any grouping.
    counters = []
    for o, s in zip(p2, slabs):
        c = o.n_dropped.clone()
        c[1] += s.overflow
        counters.append(c)

    return RenderOutput(
        image=image,
        depth=ed,
        invdepth=einv,
        radii=torch.zeros(p_full, device=on.home),  # unused by the accumulators
        contrib=contrib,
        best_colour=best_colour,
        surf_dist=surf,
        n_dropped=on.psum(counters),
    )


def render_sweep_gauss_sharded(
    scene: RenderArrays,
    cameras,
    cfg: TileConfig,
    devices: Sequence[torch.device],
    calc_surface_distance: bool = True,
    sh: Optional[SH] = None,
) -> SweepAccumulators:
    """Camera sweep with each camera's Gaussians split into depth slabs over
    ``devices``: K1 runs three times per slab and camera with the surface
    pass on (twice without).  With ``sh`` each slab's colours are its SH
    seen from the camera.  Accumulators come out on ``devices[0]``."""
    scenes = [scene.to(dev) for dev in devices]
    shs = [None if sh is None else sh.to(dev) for dev in devices]
    acc = init_accumulators(scene.means.shape[0], device=devices[0])
    for i in range(cameras.num_cameras):
        out = _render_one_slabs(
            scenes, cameras.at(i), _Walked(devices), cfg, calc_surface_distance, shs,
        )
        acc = update_accumulators(acc, out)
    return acc


def render_sweep_gauss_spmd(
    scene: RenderArrays,
    cameras,
    cfg: TileConfig,
    axis,
    calc_surface_distance: bool = True,
    sh: Optional[SH] = None,
) -> SweepAccumulators:
    """render_sweep_gauss_sharded as one rank of an SPMD program (the JAX
    package's shard_map over the gauss axis): rank d of ``axis``
    (gs2pc_torch.parallel.group.Axis) renders depth slab d of every camera,
    with the scene, cameras and SH on its own device.  Every rank returns
    the walk's accumulators bit for bit."""
    acc = init_accumulators(scene.means.shape[0], device=axis.device)
    for i in range(cameras.num_cameras):
        out = _render_one_slabs([scene], cameras.at(i), _OnAxis(axis), cfg,
                                calc_surface_distance, [sh])
        acc = update_accumulators(acc, out)
    return acc


def grid_2d(devices: Sequence[torch.device]) -> list[list[torch.device]]:
    """Near-square (cams x gauss) split of ``devices`` (make_2d_mesh's): the
    largest divisor of D that is <= sqrt(D) is the number of camera rows;
    row r holds the gauss-axis devices devices[r * G:(r + 1) * G]."""
    n = len(devices)
    rows = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    g = n // rows
    return [list(devices[r * g:(r + 1) * g]) for r in range(rows)]


def render_sweep_2d(
    scene: RenderArrays,
    cameras,
    cfg: TileConfig,
    devices: Sequence[torch.device],
    calc_surface_distance: bool = True,
    sh: Optional[SH] = None,
) -> SweepAccumulators:
    """Camera-DP x Gaussian-slab sweep (gs2pc.parallel.gauss_shard.
    render_sweep_2d): cameras split over the rows of ``grid_2d(devices)`` in
    contiguous blocks whose sizes differ by at most one; each row sweeps its
    block with the depth slabs split over the row's devices; the rows'
    accumulators merge in order on ``devices[0]`` (gs2pc_torch.sweep.
    merge_accumulators)."""
    rows = grid_2d(devices)
    acc = init_accumulators(scene.means.shape[0], device=devices[0])
    for row, (lo, hi) in zip(rows, split_evenly(cameras.num_cameras, len(rows))):
        if hi > lo:
            part = render_sweep_gauss_sharded(
                scene, cameras.sub(lo, hi, row[0]), cfg, row, calc_surface_distance, sh,
            )
            acc = merge_accumulators(acc, part.to(devices[0]))
    return acc


def render_sweep_2d_spmd(
    scene: RenderArrays,
    cameras,
    cfg: TileConfig,
    axis,
    calc_surface_distance: bool = True,
    sh: Optional[SH] = None,
) -> Optional[SweepAccumulators]:
    """render_sweep_2d as one rank of an SPMD program: ``axis.grid_2d()``
    gives this rank's slab axis (its row of grid_2d) and, on the row
    leaders, the camera axis.  Row r sweeps camera block r of
    ``split_evenly(N, rows)`` with render_sweep_gauss_spmd over its slab
    axis; the leaders then gather the rows' accumulators and merge them in
    row order (sweep.gather_merge).  Returns the walk's accumulators, bit
    for bit, on the leaders (rank 0 among them), and None on the other
    ranks."""
    slab_axis, cam_axis = axis.grid_2d()
    n_rows = axis.size // slab_axis.size
    blocks = split_evenly(cameras.num_cameras, n_rows)
    lo, hi = blocks[axis.rank // slab_axis.size]
    acc = render_sweep_gauss_spmd(scene, cameras.sub(lo, hi, axis.device), cfg, slab_axis,
                                  calc_surface_distance, sh)
    if cam_axis is None:
        return None
    with log.phase("gather"):
        return gather_merge(acc, cam_axis, blocks)
