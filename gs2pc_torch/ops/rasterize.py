"""Tile-binned splat rasterizer (counterpart of gs2pc.ops.rasterize's tile
path, render_tile_camera).

Per camera: preprocess and the blend table (K6, one launch, as the JAX
package fuses them) -> the pairs in (tile, depth bits, gid) order
(``order_pairs``: on the card a stable sort of the Gaussians by depth bits,
the exact pair expansion written in that rank order (K2, CUDA's
duplicateWithKeys, on the exclusive cumsum of the tile counts taken in rank
order), then a stable sort of the pairs by tile id alone; on the CPU the
twin's pairs and a stable sort of (tile << 32 | depth bits) int64 keys) ->
tile ranges by searchsorted -> run cap and masked-tile zeroing -> blend (K1,
which also reduces the per-Gaussian max contribution, best pixel and surface
distance).  The JAX package's static pair budget, waterfill and aligned
pair layout exist for fixed shapes on the TPU and have no counterpart here.

``render_tile_camera``'s ``init_trans`` / ``early_stop`` / ``want_trans`` /
``want_best_pix`` / ``surface_ed_override`` / ``white_bkgd`` serve the
depth-slab renderer (gs2pc_torch.parallel.gauss_shard), as in the JAX
package; K1 implements each in the kernel and in its twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gs2pc_torch.ops.blend import BACKGROUND, TILE, RenderOutput
from gs2pc_torch.ops.blend_kernel import blend_tiles
from gs2pc_torch.ops.projection import Preprocessed, project_and_pack
from gs2pc_torch.utils import log

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
    """Per-Gaussian blend rows in original order (the table half of K6's
    twin; projection.project_and_pack writes them in K6 on the card).

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
# K2: pair expansion, and the sorts around it
# --------------------------------------------------------------------- #

# CUB's arrays and storage start at 256-byte boundaries (csrc/sort.cu).
_ALIGN = 256


def _sort_scratch(lib, n: int, end_bit: int) -> int:
    """Bytes of scratch a sort of n pairs on end_bit bits needs."""
    from gs2pc_torch.ops.cuda_build import check

    n_bytes = ctypes.c_ulonglong()
    check(lib.gs2pc_sort_scratch_bytes(n, end_bit, ctypes.byref(n_bytes)),
          "gs2pc_sort_scratch_bytes")
    return n_bytes.value


def _radix_sort(lib, keys: int, vals: int, n: int, end_bit: int, scratch: int,
                scratch_bytes: int, stream: int) -> tuple:
    """Stable sort of the n int32 keys at ``keys`` (read as uint32, bits [0,
    end_bit)) carrying the int32 values at ``vals``: CUB's DeviceRadixSort
    (csrc/sort.cu) on ``stream``, with the alternates and its storage in
    ``scratch``.  Returns the device pointers of the sorted keys and values.
    The caller makes the arrays' card current.  Counts one launch on
    ``order_pairs.launches``."""
    from gs2pc_torch.ops.cuda_build import check

    out_keys, out_vals = ctypes.c_void_p(), ctypes.c_void_p()
    rc = lib.gs2pc_sort_pairs(keys, vals, n, end_bit, scratch, scratch_bytes,
                              ctypes.byref(out_keys), ctypes.byref(out_vals), stream)
    order_pairs.launches += 1
    check(rc, "gs2pc_sort_pairs")
    return out_keys.value or 0, out_vals.value or 0


def _at(buf: torch.Tensor, ptr: int, n: int) -> torch.Tensor:
    """The n int32 of ``buf`` that start at device pointer ``ptr``."""
    start = (ptr - buf.data_ptr()) // 4
    return buf[start:start + n]


def depth_order(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The gids (int32) in the rank order K2 writes pairs in: a stable sort
    by the depth's float bits read as uint32, each invalid Gaussian's key
    0xFFFFFFFF (they emit no pair, and so K2's threads past the valid ones
    end at once).  A valid Gaussian's depth is positive, so the valid ones
    come first in depth order, ties by gid.  On the card CUB's radix sort
    over 32 bits, the keys in one allocation with the sort's scratch, freed
    on return; on the CPU ``torch.sort``."""
    if depth.device.type == "cpu":
        bits = torch.where(valid, depth.contiguous().view(torch.int32), -1)
        return torch.sort(bits.long() & 0xFFFFFFFF, stable=True)[1].to(torch.int32)
    from gs2pc_torch.ops.cuda_build import check, load_library, stream_ptr

    lib = load_library()
    depth, valid = depth.contiguous(), valid.contiguous()
    P = depth.numel()
    half = -(-4 * P // _ALIGN) * _ALIGN
    with torch.cuda.device(depth.device):
        scratch = _sort_scratch(lib, P, 32)
        order = torch.empty(P, dtype=torch.int32, device=depth.device)
        buf = torch.empty((half + scratch + 3) // 4, dtype=torch.int32, device=depth.device)
        keys, stream = buf.data_ptr(), stream_ptr(depth)
        check(lib.gs2pc_depth_keys(depth.data_ptr(), valid.data_ptr(), P, keys,
                                   order.data_ptr(), stream), "gs2pc_depth_keys")
        _, vals = _radix_sort(lib, keys, order.data_ptr(), P, 32, keys + half, scratch, stream)
    # Four passes leave the result where it started; a copy otherwise, so
    # that the scratch is not held while K2 and the tile sort run.
    return order if vals == order.data_ptr() else _at(buf, vals, P).clone()


def tile_bits(num_tiles: int) -> int:
    """The bits a tile id needs: the tile sort's digits."""
    return max(1, (num_tiles - 1).bit_length())


def sort_by_tile(tiles: torch.Tensor, gids: torch.Tensor, num_tiles: int):
    """Stable sort of the (tile id, gid) pairs by tile id (int32, in [0,
    num_tiles)); returns (sorted tile ids, gids).  On the card CUB's radix
    sort over ``tile_bits(num_tiles)`` bits, which overwrites both inputs;
    on the CPU ``torch.sort``."""
    if tiles.device.type == "cpu":
        sorted_tiles, perm = torch.sort(tiles, stable=True)
        return sorted_tiles, gids[perm]
    from gs2pc_torch.ops.cuda_build import load_library, stream_ptr

    lib = load_library()
    n, bits = tiles.numel(), tile_bits(num_tiles)
    with torch.cuda.device(tiles.device):
        scratch_bytes = _sort_scratch(lib, n, bits)
        scratch = torch.empty((scratch_bytes + 3) // 4, dtype=torch.int32, device=tiles.device)
        keys, vals = _radix_sort(lib, tiles.data_ptr(), gids.data_ptr(), n, bits,
                                 scratch.data_ptr(), scratch_bytes, stream_ptr(tiles))
    if keys == tiles.data_ptr():
        return tiles, gids
    return _at(scratch, keys, n), _at(scratch, vals, n)


def duplicate_with_keys(prep: Preprocessed, cfg: TileConfig, circle_cull: bool,
                        order: torch.Tensor):
    """K2: expand every valid Gaussian into one (tile id, gid) pair per
    emitted tile, both int32, tile_id = ty * grid_w + tx; the Gaussians in
    the rank order ``order`` (int32 gids, a permutation of range(P), as
    ``depth_order`` gives), rect row-major within a Gaussian (the full-rect
    write kernel is pair-parallel and relies on that order).
    ``circle_cull`` drops rect tiles the AdR circle misses (the count and
    write passes apply the same test).  CUDA kernels for CUDA tensors; for
    CPU tensors the twin's pairs moved to rank order."""
    dev = prep.xy.device
    if dev.type == "cpu":
        keys, gids = duplicate_with_keys_torch(prep, cfg, circle_cull)
        rank = torch.empty_like(order)
        rank[order.long()] = torch.arange(order.numel(), dtype=order.dtype)
        perm = torch.sort(rank[gids.long()], stable=True)[1]
        return (keys >> 32).to(torch.int32)[perm], gids[perm]
    if dev.type != "cuda":
        raise ValueError(f"duplicate_with_keys: unsupported device {dev}")
    from gs2pc_torch.ops.cuda_build import check, launch, load_library, stream_ptr

    lib = load_library()
    xy, r2, rmin, rmax, valid, order = (
        t.contiguous() for t in (prep.xy, prep.r_alpha_sq, prep.rect_min, prep.rect_max,
                                 prep.valid, order)
    )
    if (rmin.dtype != torch.int32 or valid.dtype != torch.bool or xy.dtype != torch.float32
            or order.dtype != torch.int32):
        raise ValueError("duplicate_with_keys: unexpected preprocess or order dtypes")
    P = xy.shape[0]
    stream = stream_ptr(xy)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    rc = launch(
        lib.gs2pc_count_pairs, xy,
        xy.data_ptr(), r2.data_ptr(), rmin.data_ptr(), rmax.data_ptr(), valid.data_ptr(),
        P, int(circle_cull), counts.data_ptr(), stream,
    )
    duplicate_with_keys.launches += 1
    check(rc, "gs2pc_count_pairs")
    ends = torch.cumsum(counts.index_select(0, order), 0, dtype=torch.int64)
    total = int(ends[-1]) if P else 0
    tiles = torch.empty(total, dtype=torch.int32, device=dev)
    gids = torch.empty(total, dtype=torch.int32, device=dev)
    rc = launch(
        lib.gs2pc_write_pairs, xy,
        xy.data_ptr(), r2.data_ptr(), rmin.data_ptr(), rmax.data_ptr(), order.data_ptr(),
        ends.data_ptr(), P, total, int(circle_cull), cfg.grid_w,
        tiles.data_ptr() if total else None, gids.data_ptr() if total else None, stream,
    )
    duplicate_with_keys.launches += 1
    check(rc, "gs2pc_write_pairs")
    return tiles, gids


duplicate_with_keys.launches = 0


def duplicate_with_keys_torch(prep: Preprocessed, cfg: TileConfig, circle_cull: bool):
    """The plain PyTorch twin of K2 as the JAX package orders it: (tile <<
    32 | depth bits) int64 keys and gids, in gid order, rect row-major within
    a Gaussian; repeat_interleave over the full rects, then the circle test
    as a boolean filter (order kept)."""
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


def _check_pair_count(n: int) -> None:
    if n >= 2**31:
        # K1 indexes the pair run, and the tile sort its items, with 32-bit ints.
        raise ValueError(f"{n} pairs in one camera exceed K1's 2^31 limit")


def order_pairs(prep: Preprocessed, cfg: TileConfig, circle_cull: bool):
    """Every pair of the camera in (tile, depth bits, gid) order, K1's input
    order: (sorted tile ids, sorted gids), int32.  On the card the depth
    sort (``depth_order``), K2 in that rank order, then the stable tile sort
    (``sort_by_tile``): stability makes it the permutation the int64 key
    sort gives.  On CPU tensors the twin's int64 keys through ``sort_pairs``.
    ``order_pairs.launches`` counts the sorts' launches, two a camera."""
    if prep.xy.device.type == "cpu":
        with log.trace_range("k2_pairs"):
            keys, gids = duplicate_with_keys_torch(prep, cfg, circle_cull)
        _check_pair_count(gids.numel())
        with log.trace_range("key_sort"):
            sorted_keys, sorted_gid = sort_pairs(keys, gids)
        return (sorted_keys >> 32).to(torch.int32), sorted_gid
    with log.trace_range("depth_sort"):
        order = depth_order(prep.depth, prep.valid)
    with log.trace_range("k2_pairs"):
        tiles, gids = duplicate_with_keys(prep, cfg, circle_cull, order)
    _check_pair_count(gids.numel())
    with log.trace_range("key_sort"):
        return sort_by_tile(tiles, gids, cfg.num_tiles)


order_pairs.launches = 0


def tile_ranges(sorted_tiles: torch.Tensor, num_tiles: int):
    """(start, run length) of every tile's contiguous pair run, from the
    pairs' sorted tile ids."""
    tids = torch.arange(num_tiles, device=sorted_tiles.device, dtype=sorted_tiles.dtype)
    starts = torch.searchsorted(sorted_tiles, tids, right=False)
    ends = torch.searchsorted(sorted_tiles, tids, right=True)
    return starts, ends - starts


def _tile_max(x: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """(Hp, Wp) or (Hp * Wp,) -> per-tile max in tile-id order."""
    return x.reshape(cfg.grid_h, TILE, cfg.grid_w, TILE).amax(dim=(1, 3)).reshape(-1)


def blend_inputs(prep: Preprocessed, colours: torch.Tensor, camera, cfg: TileConfig,
                 calc_surface_distance: bool, table: Optional[torch.Tensor] = None, **modes):
    """Everything K1 takes for one camera, and the per-tile run lengths.
    ``table`` is the camera's blend table when it is already packed
    (project_and_pack); None packs it from ``prep`` and ``colours``.

    Returns (args, kwargs, runs): ``blend_tiles(*args, **kwargs)`` blends
    the camera; ``runs`` are the uncapped per-tile pair counts, zero on
    fully masked tiles (they blend nothing and stay out of the surface
    min).  ``modes`` (init_trans, ed_override, early_stop, bg) pass
    through to K1."""
    if table is None:
        table = pack_blend_table(prep, colours, compact=cfg.compact)
    sorted_tile, sorted_gid = order_pairs(prep, cfg, circle_cull=not calc_surface_distance)
    starts, runs = tile_ranges(sorted_tile, cfg.num_tiles)
    if camera.mask is not None:
        live = _tile_max((camera.mask != 0).to(torch.float32), cfg) > 0.0
        runs = torch.where(live, runs, 0)
    counts = torch.clamp(runs, max=cfg.run_cap)
    args = (table, sorted_gid, starts.to(torch.int32), counts.to(torch.int32), camera.mask)
    kwargs = dict(
        width=camera.width, height=camera.height, width_pad=cfg.width_pad,
        height_pad=cfg.height_pad, run_chunk=cfg.run_chunk,
        with_surface=calc_surface_distance, surface_compact=cfg.surface_compact, **modes,
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
    white_bkgd: bool = True,
    init_trans: Optional[torch.Tensor] = None,
    early_stop: bool = True,
    want_trans: bool = False,
    want_best_pix: bool = False,
    surface_ed_override: Optional[torch.Tensor] = None,
    blend=None,
) -> RenderOutput:
    """Render one ``camera.Camera`` (its own mask applies); returns the image
    and the per-Gaussian accumulator inputs, as
    gs2pc.ops.rasterize.render_tile_camera.

    The depth-slab modes: ``init_trans`` (Hp * Wp,) seeds each pixel's
    transmittance, ``early_stop=False`` turns the T < 1e-4 stop off,
    ``surface_ed_override`` (Hp * Wp,) is the depth the surface pass
    measures against, ``want_trans`` / ``want_best_pix`` fill
    ``RenderOutput.trans`` / ``best_pix``; the background is white, or 0
    with ``white_bkgd=False``.  ``blend`` replaces K1's wrapper
    ``blend_tiles`` (None), as the tools that time or ablate its twin
    ``blend_kernel.blend_tiles_torch`` on the card do."""
    with log.trace_range("k6_project"):
        prep, table = project_and_pack(
            means, cov_factors, opacities, alive, colours, camera, cfg,
            adaptive_radius=not calc_surface_distance,
        )
    args, kwargs, runs = blend_inputs(
        prep, colours, camera, cfg, calc_surface_distance, table=table,
        init_trans=init_trans, ed_override=surface_ed_override, early_stop=early_stop,
        bg=BACKGROUND if white_bkgd else 0.0,
    )
    with log.trace_range("k1_blend"):
        res = (blend or blend_tiles)(*args, **kwargs)

    # Counters [pairs blended, window-truncated (none: the expansion is
    # exact), run-cap-dropped pairs, run-cap drops on tiles whose pixels
    # still had visible transmittance], then K1's work [pairs streamed:
    # per tile its entered chunks x run_chunk within the capped count;
    # pairs the surface pass streamed: the same with surface_compact, else
    # the capped count, 0 without it; padded pixels].
    d_runs = runs.to(torch.float64)
    capped = torch.clamp(d_runs, max=float(cfg.run_cap)).sum()
    cap_drop_tiles = torch.clamp(d_runs - cfg.run_cap, min=0.0)
    live_tile = _tile_max(res.live, cfg) > _LIVE_T_FLOOR
    streamed = torch.minimum(res.chunks * cfg.run_chunk, args[3]).sum(dtype=torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=d_runs.device)
    if calc_surface_distance:
        surface = streamed if cfg.surface_compact else capped
    else:
        surface = zero
    counters = torch.stack([
        capped,
        zero,
        cap_drop_tiles.sum(),
        torch.where(live_tile, cap_drop_tiles, 0.0).sum(),
        streamed,
        surface,
        torch.full((), float(cfg.width_pad * cfg.height_pad), dtype=torch.float64,
                   device=d_runs.device),
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
        trans=res.trans if want_trans else None,
        best_pix=res.best_pix if want_best_pix else None,
        n_dropped=counters[:4],
        k1_work=counters[4:],
    )
