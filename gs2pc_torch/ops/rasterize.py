"""Tile-binned splat rasterizer (counterpart of gs2pc.ops.rasterize's tile
path, render_tile_camera).

Per camera: preprocess -> exact pair expansion (K2, CUDA's
duplicateWithKeys, on the exclusive cumsum of per-Gaussian tile counts) ->
stable sort of (tile << 32 | depth bits) int64 keys -> tile ranges by
searchsorted -> run cap and masked-tile zeroing -> blend (K1, which also
reduces the per-Gaussian max contribution, best pixel and surface
distance).  The JAX package's static pair budget, waterfill and aligned
pair layout exist for fixed shapes on the TPU and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gs2pc_torch.ops.blend import TILE, RenderOutput
from gs2pc_torch.ops.blend_kernel import blend_tiles
from gs2pc_torch.ops.projection import Preprocessed, preprocess

# A dropped pair can still matter where a pixel's remaining transmittance
# exceeds the blend's own alpha cutoff (1/255).
_LIVE_T_FLOOR = 1.0 / 255.0


class TileConfig(NamedTuple):
    """What the GPU tile renderer needs to know about its tiling."""

    width_pad: int
    height_pad: int
    run_cap: int = 4096  # max pairs blended per tile (front to back)
    run_chunk: int = 128  # pairs per blend step (the early-exit granularity)
    compact: bool = False  # rgb quantised to one 24-bit lane of the table
    # The surface min sees only the chunks the blend streamed before the
    # tile was done (the reference's block-level break); False = every
    # capped run pair.
    surface_compact: bool = False

    @property
    def grid_w(self) -> int:
        return self.width_pad // TILE

    @property
    def grid_h(self) -> int:
        return self.height_pad // TILE

    @property
    def num_tiles(self) -> int:
        return self.grid_w * self.grid_h


def pack_blend_table(prep: Preprocessed, colours: torch.Tensor, compact: bool = False):
    """Per-Gaussian blend rows in original order.

    Full: 16 lanes [x y A B C opacity depth 0 | r g b 0 0 0 0 0].
    Compact: 8 lanes [x y A B C opacity depth rgb24], rgb24 an exact float
    integer of the round-to-nearest 8-bit channels."""
    P = prep.xy.shape[0]
    geo = [prep.xy, prep.conic, prep.opacity[:, None], prep.depth[:, None]]
    if compact:
        q = torch.round(torch.clamp(colours, 0.0, 1.0) * 255.0).to(torch.int32)
        rgb24 = (q[:, 0] << 16) | (q[:, 1] << 8) | q[:, 2]
        return torch.cat(geo + [rgb24.to(torch.float32)[:, None]], dim=1)
    z = colours.new_zeros
    return torch.cat(geo + [z((P, 1)), colours, z((P, 5))], dim=1)


# --------------------------------------------------------------------- #
# K2: pair expansion
# --------------------------------------------------------------------- #

def duplicate_with_keys(prep: Preprocessed, cfg: TileConfig, circle_cull: bool):
    """Expand every valid Gaussian into one (key, gid) pair per emitted tile.

    key = (tile_id << 32) | float_bits(depth) as int64, tile_id = ty *
    grid_w + tx; pairs are written in gid order, rect row-major within a
    Gaussian.  ``circle_cull`` drops rect tiles the AdR circle misses (the
    count and write passes apply the same test).  CUDA kernels for CUDA
    tensors, the twin for CPU tensors."""
    dev = prep.xy.device
    if dev.type == "cpu":
        return duplicate_with_keys_torch(prep, cfg, circle_cull)
    if dev.type != "cuda":
        raise ValueError(f"duplicate_with_keys: unsupported device {dev}")
    from gs2pc_torch.ops.cuda_build import check, load_library, stream_ptr

    lib = load_library()
    xy, r2, rmin, rmax, valid, depth = (
        t.contiguous() for t in (prep.xy, prep.r_alpha_sq, prep.rect_min, prep.rect_max,
                                 prep.valid, prep.depth)
    )
    if rmin.dtype != torch.int32 or valid.dtype != torch.bool or xy.dtype != torch.float32:
        raise ValueError("duplicate_with_keys: unexpected preprocess dtypes")
    P = xy.shape[0]
    stream = stream_ptr(xy)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    rc = lib.gs2pc_count_pairs(
        xy.data_ptr(), r2.data_ptr(), rmin.data_ptr(), rmax.data_ptr(), valid.data_ptr(),
        P, int(circle_cull), counts.data_ptr(), stream,
    )
    duplicate_with_keys.launches += 1
    check(rc, "gs2pc_count_pairs")
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    offsets = ends - counts
    total = int(ends[-1]) if P else 0
    keys = torch.empty(total, dtype=torch.int64, device=dev)
    gids = torch.empty(total, dtype=torch.int32, device=dev)
    rc = lib.gs2pc_write_pairs(
        xy.data_ptr(), r2.data_ptr(), rmin.data_ptr(), rmax.data_ptr(), valid.data_ptr(),
        depth.data_ptr(), offsets.data_ptr(), P, int(circle_cull), cfg.grid_w,
        keys.data_ptr() if total else None, gids.data_ptr() if total else None, stream,
    )
    duplicate_with_keys.launches += 1
    check(rc, "gs2pc_write_pairs")
    return keys, gids


duplicate_with_keys.launches = 0


def duplicate_with_keys_torch(prep: Preprocessed, cfg: TileConfig, circle_cull: bool):
    """The plain PyTorch twin of K2: repeat_interleave over the full rects,
    then the circle test as a boolean filter (order kept)."""
    dev = prep.xy.device
    P = prep.xy.shape[0]
    rmin, rmax = prep.rect_min.long(), prep.rect_max.long()
    rw = rmax[:, 0] - rmin[:, 0]
    area = torch.where(prep.valid, rw * (rmax[:, 1] - rmin[:, 1]), 0)
    gid = torch.repeat_interleave(torch.arange(P, device=dev), area)
    k = torch.arange(gid.shape[0], device=dev) - (torch.cumsum(area, 0) - area)[gid]
    tx = rmin[gid, 0] + k % rw[gid]
    ty = rmin[gid, 1] + k // rw[gid]
    if circle_cull:
        px, py = prep.xy[gid, 0], prep.xy[gid, 1]
        fx = tx.to(torch.float32) * TILE
        fy = ty.to(torch.float32) * TILE
        ddx = torch.minimum(torch.maximum(px, fx), fx + (TILE - 1)) - px
        ddy = torch.minimum(torch.maximum(py, fy), fy + (TILE - 1)) - py
        hit = ddx * ddx + ddy * ddy <= prep.r_alpha_sq[gid]
        gid, tx, ty = gid[hit], tx[hit], ty[hit]
    dbits = prep.depth.contiguous().view(torch.int32).long()[gid]
    keys = ((ty * cfg.grid_w + tx) << 32) | dbits
    return keys, gid.to(torch.int32)


def sort_pairs(keys: torch.Tensor, gids: torch.Tensor):
    """Stable sort by the int64 key.  Pairs arrive in gid order, so equal
    (tile, depth) keys keep gid order: the (tile, depth bits, gid) order of
    the JAX package."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, gids[order]


def tile_ranges(sorted_keys: torch.Tensor, num_tiles: int):
    """(start, run length) of every tile's contiguous pair run."""
    tile_of = sorted_keys >> 32
    tids = torch.arange(num_tiles, device=sorted_keys.device, dtype=torch.int64)
    starts = torch.searchsorted(tile_of, tids, right=False)
    ends = torch.searchsorted(tile_of, tids, right=True)
    return starts, ends - starts


def _tile_max(x: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """(Hp, Wp) or (Hp * Wp,) -> per-tile max in tile-id order."""
    return x.reshape(cfg.grid_h, TILE, cfg.grid_w, TILE).amax(dim=(1, 3)).reshape(-1)


def blend_inputs(prep: Preprocessed, colours: torch.Tensor, camera, cfg: TileConfig,
                 calc_surface_distance: bool):
    """Everything K1 takes for one camera, and the per-tile run lengths.

    Returns (args, kwargs, runs): ``blend_tiles(*args, **kwargs)`` blends
    the camera; ``runs`` are the uncapped per-tile pair counts, zero on
    fully masked tiles (they blend nothing and stay out of the surface
    min)."""
    table = pack_blend_table(prep, colours, compact=cfg.compact)
    keys, gids = duplicate_with_keys(prep, cfg, circle_cull=not calc_surface_distance)
    if gids.numel() >= 2**31:
        # K1 indexes the pair run with 32-bit ints.
        raise ValueError(f"{gids.numel()} pairs in one camera exceed K1's 2^31 limit")
    sorted_keys, sorted_gid = sort_pairs(keys, gids)
    starts, runs = tile_ranges(sorted_keys, cfg.num_tiles)
    if camera.mask is not None:
        live = _tile_max((camera.mask != 0).to(torch.float32), cfg) > 0.0
        runs = torch.where(live, runs, 0)
    counts = torch.clamp(runs, max=cfg.run_cap)
    args = (table, sorted_gid, starts.to(torch.int32), counts.to(torch.int32), camera.mask)
    kwargs = dict(
        width=camera.width, height=camera.height, width_pad=cfg.width_pad,
        height_pad=cfg.height_pad, run_chunk=cfg.run_chunk,
        with_surface=calc_surface_distance, surface_compact=cfg.surface_compact,
    )
    return args, kwargs, runs


def render_tile_camera(
    means: torch.Tensor,
    cov_factors: torch.Tensor,
    opacities: torch.Tensor,
    colours: torch.Tensor,
    alive: torch.Tensor,
    camera,
    cfg: TileConfig,
    calc_surface_distance: bool = True,
) -> RenderOutput:
    """Render one ``camera.Camera`` (its own mask applies); returns the image
    and the per-Gaussian accumulator inputs, as
    gs2pc.ops.rasterize.render_tile_camera."""
    prep = preprocess(
        means, cov_factors, opacities, alive, camera,
        adaptive_radius=not calc_surface_distance,
    )
    args, kwargs, runs = blend_inputs(prep, colours, camera, cfg, calc_surface_distance)
    res = blend_tiles(*args, **kwargs)

    # Counters [pairs blended, window-truncated (none: the expansion is
    # exact), run-cap-dropped pairs, run-cap drops on tiles whose pixels
    # still had visible transmittance].
    d_runs = runs.to(torch.float32)
    cap_drop_tiles = torch.clamp(d_runs - cfg.run_cap, min=0.0)
    live_tile = _tile_max(res.live, cfg) > _LIVE_T_FLOOR
    diag = torch.stack([
        torch.clamp(d_runs, max=float(cfg.run_cap)).sum(),
        torch.zeros((), device=d_runs.device),
        cap_drop_tiles.sum(),
        torch.where(live_tile, cap_drop_tiles, 0.0).sum(),
    ])

    contrib = res.contrib
    best_colour = torch.where(
        (contrib > 0.0)[:, None], res.image.reshape(-1, 3)[res.best_pix], 0.0
    )
    return RenderOutput(
        image=res.image,
        depth=res.depth,
        invdepth=res.invdepth,
        radii=prep.radius,
        contrib=contrib,
        best_colour=best_colour,
        surf_dist=res.surf_dist,
        n_dropped=diag,
    )
