"""Smoke test of gs2pc_torch on CUDA GPUs: builds the kernels, holds each
against its plain PyTorch twin in every mode, runs the production
conversion end to end through ``gs2pc_torch.cli.main``, runs the three
multi-device sweeps at full width, as one-thread walks and as SPMD programs
of one process per device, splits the sampler over those processes, and
checks what they produce.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero):
  1. device    nvidia-smi name and power limit, torch's device name
  2. build     nvcc build + load of gs2pc_torch/csrc/*.cu, g++ builds of the
               PLY writer and the mesher
  3. K2        pair expansion vs twin: 200k Gaussians, one 1280x720 camera,
               keys and gids equal exactly before and after the sort
               (full-rect and circle-cull modes)
  4. K1        tile blend vs twin: 20k Gaussians at 256x192, vignette mask,
               surface pass, compact tables on and off
  5. K1 modes  the depth-slab modes vs twin at the same shape: no stop (with
               the final T), a seeded starting-T map, a surface depth map
               under both surface_compact settings, compact on and off
  6. e2e       the capture of gs2pc_torch.utils.capture (3M Gaussians, 16
               cameras at 1280x720, masks) -> 10M points with surface
               distances on, streamed through the native PLY writer; the CLI at
               its default --num_devices 0, so on a machine with several
               cards this and every later CLI phase sweeps one process per
               card, and the launches checked are those of every rank (K5
               once a sampling on every rank: 1 a card here, 2 with
               --generate_mesh; K6 once a camera, never its twin);
               point_sampling beside the sampler's before K5
  7. timing    K1 and K2 on camera 0 of that scene, the shape the main path
               gives them: held against their twins with the bounds of
               phases 3-4 (K2 before and after the sort), then timed against
               them, each launch alone and through its wrapper (K2: count,
               scan + sync, write); the distribution of K1's chunks entered;
               then K5 on that scene at 10M points of quotas by size (key
               PRNGKey(0)): owners and points equal to its twin on the card
               bit for bit, the 2- and 4-block splits on one card equal to
               the whole range, timed launch alone and through the wrapper
               beside the twin and the bound (recounted from the call's
               quotas, the count with every slot drawing beside it); the
               slots that draw (not centres), K5's grid, registers and
               spills
  8. slab      K1's three depth-slab passes of slab 1 of 4 on camera 0 of
               that scene (the real prefix and the real combined depth map),
               held against the twin and timed
  9. sharded   the e2e scene's first 4 cameras at 1280x720, masks, surface
               pass on, run cap above the longest tile run: the depth-slab
               and 2-D sweeps on [cuda:0] * 4 through pipeline.run_render_sweep
               (the --shard_axis gauss|both dispatch) and the camera sweep on
               [cuda:0] * 2 against the single-device sweep
 10. probes    the tools' probe path: gs2pc_torch.tools.cuda_probe (K3, nine
               ops) on the TPU tool's ones and a seeded uniform(0.5, 1.5)
               block, cuda_probe2 (K4, levels 0-6) on try_level's inputs and
               a seeded table; each held to its twin (bit for bit for roll,
               min and scan, 1e-5 relative elsewhere) and timed, launch alone
               and through the wrapper, beside an empty kernel's launch (the
               floor) and torch.roll / torch.cumprod for roll and scan
 11. oracle    validate_psnr's functions on the capture scene (200k Gaussians,
               one 1280x720 camera, its mask): the tile renderer at the
               production config against render_dense(rect_cull=True), PSNR
               gated at 40 dB; the exact config (run cap above the longest
               run, compact off) printed beside it
 12. dense CLI gs2pc_torch.cli.main --renderer_type dense --profile_dir on a
               20k-Gaussian capture (4 cameras at 256x192, masks): points,
               writer, the trace and its phases, colours against the tile CLI
 13. SH        the e2e scene written as a degree-3 SH export (59 floats a
               Gaussian) -> the CLI with --sh_colour_eval --save_sweep over
               the 16 cameras, 10M points; colours other than the DC ones;
               the scene its load decoded on the card bit-equal to the host
               parse's; K1 bit-equal to its twin on a per-camera SH table
               (20k Gaussians at 256x192)
 14. resume    the saved sweep loaded (equal to the saved accumulators bit
               for bit) and the conversion run again from it without
               transforms: the same PLY, byte for byte; then the record
               decode (csrc/plydecode.cu) over every record of the SH export
               and a few edge rows, blocks of CARD_BLOCK_ROWS, with and
               without the SH plane, compact and full: bit-equal to its twin
               and to the host parse's fill of the same bytes, one launch a
               block; timed on one block beside the twin, the host fill and
               the bound
 15. mesh      BASELINE config 5: --clean_pointcloud --generate_mesh at the
               defaults (depth 10 -> grid 384, 10 smoothing rounds), 16
               cameras, 10M points: the surface quota, the native mesher,
               each step's time; statistical_outlier_mask on the card
               against the CPU on 200k surface points
 16. capacity  --auto_capacity with 4 cameras at --max_pairs_per_tile 256:
               K1 launches = cameras x attempts, the final run cap and drop
               share
 17. covariances Gaussians.from_covariances on 1M seeded covariances, half
               not PSD, on the card against the CPU
 18. preview   gs2pc_torch.tools.render_preview --depth on the e2e capture,
               4 cameras at 1280x720: each decoded PNG equal to the 8-bit
               image (and normalised depth) of sweep.render_camera; K1 4 and
               K2 8 launches
 19. convert   gs2pc_torch.tools.convert_format on the 3M-Gaussian .ply ->
               .splat -> .ply, the round trip held to the CPU test's bounds
 20. splits    the 16 e2e cameras at 1280x720: the camera split on
               [cuda:0] * 2, the depth-slab and 2-D sweeps on [cuda:0] * 4
               (and all three on every card of a machine with several), each
               run twice: the same bits both times, held to one device, walls
               beside the one-device sweep's
 21. dry run   parallel.dryrun.dryrun_multichip(8) on [cuda:0] * 8 (and on
               every card of a machine with several), a verdict line per axis
 22. forensics gs2pc_torch.tools.pixel_forensics on phase 11's tile and
               oracle images: the float64 truth at the 12 worst pixels, which
               side is wrong; under 60 s
 23. spmd      phase 20's sweeps as SPMD programs, one process per rank
               (parallel/launch.py; collectives of parallel/group.py): the
               camera split on [cuda:0] * 2, the depth-slab and 2-D sweeps on
               [cuda:0] * 4 through gloo (and all three over every card
               through NCCL on a machine with several), each bit-equal to its
               walk, held to one device, every rank's K1 launches its share;
               walls and the spawned ranks' bring-up.  With several cards
               also the CLI at --num_devices 0 and --shard_axis gauss, PLYs
               byte-equal to the walk's, K1 and K2 launched 16 and 32 times
               (3 x cards times that on the slabs) over all the ranks, K5 once
               on each, and a rank that raises over NCCL.  Each spawn also
               runs the e2e conversion with --generate_mesh (convert_rank):
               every rank samples its block of the cloud and of the surface
               cloud with K5 (2 launches a rank), and both PLYs are
               byte-equal to the walk's on the same devices, which samples
               on one card
 24. transfers (run right after 6) the e2e cloud, its points still on the
               card (pipeline.LazyPointCloud): its PLY written through the
               stream (pinned chunks, the native session: "native_stream")
               and through the eager route (pageable fetch of the whole
               buffer + gs2pc_write_ply_expand), and that writer alone on
               points on the host, five each in turns, byte-equal; the
               fetch alone, pageable, pinned and in pinned chunks; phase 6's
               scene_parse, scene_upload, point_sampling and ply_write beside
               the eager port's; one more CLI conversion under
               torch.profiler, its copies by kind and phase: no pageable
               device-to-host copy of
               the point buffer, ply_write's copies pinned; the bytes fetched
               and the planes' bytes uploaded from pinned memory printed
 25. bench     gs2pc_torch.bench.main() in this process at its defaults (the
               north-star capture: 3M Gaussians, 45 cameras at 1280x720,
               masks, surface pass, 10M points; two conversions, cold and
               steady, on one card), its gate at the oracle phase's 200k
               Gaussians with a fresh oracle cache: exit 0, steady, the points
               written, the gate passed at coverage 1.0 with the accumulators
               inside their gates, K1 91, K2 182, K5 2 and K6 91 launches (and
               K6 without a table for the gate's oracle); its last record
               printed as "bench: {...}"
 26. K6        (run right after 7) the per-camera front end on camera 0 of
               the e2e scene (3M Gaussians, 1280x720, its mask): both radius
               modes and both table layouts, and preprocess without a table,
               every output equal to the twin's (preprocess_torch +
               pack_blend_table on the card) bit for bit; the main path's
               call (full rect, compact) and the table-less one timed launch
               alone and through the wrapper beside the twin and k6_bound
Every CLI phase also fails if K6's twin ran (a card's conversion launches K6
once a camera, beside K1).
The line before the last is the kernels' JSON record (max_abs_err at the
shape of phases 7-8 and 10 (K5: phase 7's, K6: phase 26's); ms the time through the wrapper, also given as
wrapper_ms, and launch_ms the launch alone, K2's count + write; K3 as the
mean of its nine ops and apart for roll and scan, the ops one PyTorch call
computes (library_ms: torch.roll, torch.cumprod); launches from the e2e run
and the bench phase for the main mode, K2, K5 and K6, from the depth-slab sweep
of phase 9 for the others and from the probe tools' run of phase 10 for
K3 / K4), the last line the device record.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))

N_E2E_GAUSSIANS = 3_000_000
N_E2E_CAMERAS = 16  # the capture's north star has 45; cut so the build and checks fit
E2E_WIDTH, E2E_HEIGHT = 1280, 720
N_POINTS = 10_000_000
N_SHARD_CAMERAS = 4
N_SLABS = 4

# Twin bounds.  Kernel and twin run the same float operations in the same
# order; expf and torch.exp may round differently, so floats are held to a
# few ulps of the accumulated sums; a near-tie in a pair's max contribution
# can pick another pixel, so best colour is held on a share of the Gaussians.
TOL_IMAGE = 1e-5
TOL_CONTRIB = 1e-6
TOL_SURF = 1e-5
TOL_BEST = 1e-5
BEST_SHARE = 0.999

# Sharded sweeps vs one device (tests/test_sharding.py's bounds): f32
# summation order, argmax-pixel ties for the colour.
TOL_SHARD_CONTRIB = 1e-5
TOL_SHARD_SURF = 1e-4
TOL_SHARD_COLOUR = 1e-3
SHARD_COLOUR_SHARE = 0.97

# Roofline of one H100 SXM (NVIDIA's data sheet): device memory and fp32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# K1's float operations per streamed (pair, pixel): power 6, exp ~8,
# alpha / stop test 4, colour / depth / inverse-depth sums 10, T 2; and per
# (pair, pixel) of the surface pass: subtract, abs, min.
K1_BLEND_FLOPS = 30
K1_SURF_FLOPS = 3
TPX = 256

# K5's operations per point, by piece (chip_smoke.k5_bound): a threefry2x32
# block (20 rounds of add, rotate, xor; 5 key injections; the counter split
# and the final xor), a float from its bits (shift, or, sub, scale, shift,
# max), one erf_inv less its libm calls (square, negate, compare, shift, 8
# Horner steps, the product, the edge test), the chi_3 CDF less its libm
# calls (6 multiplies and subtracts), a bisection round less its CDF (add,
# halve, compare, select; a level of the threshold table is the same with
# the CDF read, not computed), an owner-search probe (halve, load, compare,
# select), and what remains: for every slot the scale, rotation (2 cross
# products, the quaternion sum) and mean (K5_STORE_OPS), for a slot that
# draws also the radius, norm, ratio and direction (K5_DIRECTION_OPS;
# K5_REST_OPS is both).  The libm calls are counted by their
# instructions on this card: expf 8, erff 14, log1pf 16, sqrtf 6, an IEEE
# division 8.  Integer operations are counted against the fp32 rate: the
# bound stays a least time.
K5_THREEFRY_OPS = 77
K5_FLOAT_OPS = 6
K5_ERFINV_OPS = 24
K5_CDF_OPS = 6
K5_BISECT_OPS = 4
K5_SEARCH_OPS = 4
K5_STORE_OPS = 48
K5_DIRECTION_OPS = 12
K5_REST_OPS = K5_STORE_OPS + K5_DIRECTION_OPS
K5_LIBM_OPS = {"expf": 8, "erff": 14, "log1pf": 16, "sqrtf": 6, "div": 8}
K5_BISECT_ROUNDS = 26
# The e2e cell's point_sampling before K5 (PERF.md §5; NVIDIA H100
# 80GB HBM3, 700.00 W).
PARENT_POINT_SAMPLING_S = 0.154

# The e2e phases before the streamed transfers, when the point buffer was
# fetched pageable within point_sampling (PERF.md §5's earlier archive run;
# NVIDIA H100 80GB HBM3, 700.00 W; scene_upload was not printed).
PARENT_TRANSFER_PHASES = {"scene_parse": 0.733, "scene_upload": None, "point_sampling": 0.115,
                          "ply_write": 0.133}

# K5 vs its twin: the same float operations in the same order, with the
# libm functions PyTorch's CUDA kernels call (csrc/sampler.cu).
TOL_K5 = 0.0

# K6's operations per Gaussian (chip_smoke.k6_bound), each float or integer
# instruction one operation at the fp32 rate, libm calls as K5_LIBM_OPS
# (logf counted as log1pf): the view and clip rows 36 (4 rows of 3
# multiplies and 3 adds, 18 each for view and clip: rows 0-2 of the view,
# 0, 1 and 3 of the clip), 1 / w and the NDC and pixel maps 19, tz 3, the
# clamped tx / ty 22, the rotated factor 45, 1 / z and J's terms 16, the two
# rows of M2 18, cov2D and its dilation 17, det, its inverse and the conic
# 17, the eigenvalue 13, the opacity's log 18, r_alpha 6, the two radii
# 17, the four tile indices 36, tiles_touched 3, valid 5; the compact row
# adds 20 (three clamped, scaled, rounded channels, their shifts and ors,
# the float cast).
K6_OPS = 291
K6_COMPACT_OPS = 20

# The record decode's bound (chip_smoke.phase_ply_decode), a row of the main
# path's call (compact colours, no SH plane): the bytes it writes (xyz,
# colours, log_scales: 12 B each; rots 16 B) beside the record it reads; its
# float operations, counted as K6_OPS (libm as K5_LIBM_OPS): the colours 3 x
# (multiply, add, two clip compares) and their quantise 3 x (multiply,
# round, two casts, multiply), the norm's 4 squares, 3 adds and square root
# (6), its clamp 2, the 4 divisions (8 each), the sign test and 4 flips;
# the NaN tests that repeat SSE's rules are not counted, so the bound stays
# a least time.
PLY_DECODE_WRITE_BYTES = 52
PLY_DECODE_OPS = 79

# K3 / K4 vs their twins: the sums run in another order in K3 (warp
# shuffles) than in its twin; K4 and its twin make the same operations, so
# only expf / logf against torch's exp / log could part them.
PROBE_RTOL = 1e-5
# The least float operations K4's level 6 needs per (pixel, lane) of a chunk
# it enters, each instruction one operation at the fp32 rate, counted from
# tools/pallas_probe2.py:60-93: dx 1, power 2, exp 2 (the ex2 special
# function and its log2(e) scale), opacity product and 0.99 min 2, the two
# ok compares and the select 3, 1 - a 1, the exclusive product 1 (one
# multiply per lane; the kernel's log-step scan makes 7), t_before and w 2,
# the stop trigger 3, the colour and depth sums 2, log 2 (lg2 and its
# scale) and its sum 1, the max over pixels and the argmax compare 2.
K4_FLOPS = 24
# The oracle phase (tools/validate_psnr.py:88-89 names 40 dB "visually
# lossless"; DESIGN §2 expects the exact config within 2e-4 of the oracle).
N_ORACLE_GAUSSIANS = 200_000
PSNR_FLOOR_DB = 40.0
N_DENSE_CLI_GAUSSIANS = 20_000
N_DENSE_CLI_CAMERAS = 4
DENSE_CLI_WIDTH, DENSE_CLI_HEIGHT = 256, 192

# The feature-flag phases (13-17).  SH: the e2e scene as a degree-3 SH
# export, f_rest ~ N(0, 0.02) as tests/fixture_scene.py:123.
SH_REST_STD = 0.02
N_SH_K1_GAUSSIANS = 20_000
# --auto_capacity: 4 cameras at a run cap the capture's tiles overflow.
N_AUTO_CAMERAS = 4
AUTO_RUN_CAP = 256
N_AUTO_POINTS = 1_000_000
# The outlier mask on the card against the CPU: masks equal except for
# points whose mean kNN distance lies within 1e-6 relative of the threshold.
N_OUTLIER_CHECK = 200_000
OUTLIER_NEAR_RTOL = 1e-6
# from_covariances on the card against the CPU (it repairs in float64, so
# the keep masks do not follow either device's rounding).
N_COVARIANCES = 1_000_000
COV_RTOL = 1e-5
# The seventh slice's phases (18-22).  Preview: the e2e capture's first
# cameras at full width; convert: the round trip held to
# tests/test_torch_tools_more.py's (and tests/test_tools.py's) tolerances.
N_PREVIEW_CAMERAS = 4
TOL_CONVERT_XYZ = 1e-5
TOL_CONVERT_OPACITY = 2 / 255
TOL_CONVERT_LOG_SCALE = 1e-4
N_SPLIT_SLABS = 4
N_DRYRUN_DEVICES = 8
N_FORENSIC_PIXELS = 12
FORENSICS_LIMIT_S = 60.0
MESH_PHASES = ("clean_pointcloud", "surface_sampling", "mesh_outliers", "mesh_density_grid",
               "mesh_iso_level", "mesh_marching_tetrahedra", "mesh_smooth", "mesh_attributes",
               "mesh_write")

# K1's modes as they appear in the kernels record: blend_kernel.mode_of name.
K1_MODES = ("early_stop=False", "init_trans", "ed_override")
# What the camera data-parallel sweep keeps exactly.
EXACT = ("max_contribution", "colours", "min_surface_distance", "n_dropped")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scene_on_device(arrays, device):
    from gs2pc_torch.models.gaussians import Gaussians

    return Gaussians.from_numpy(
        arrays.xyz, arrays.log_scales, arrays.rots, arrays.colours, arrays.opacities,
        device=device,
    )


def camera_batch(n_cams, width, height, device, with_masks):
    from gs2pc_torch.camera import build_camera_batch
    from gs2pc_torch.utils import capture

    transforms, intr = capture.make_poses(n_cams, width, height)
    masks = None
    if with_masks:
        m = capture.vignette_mask(width, height)
        masks = {name: m for name in transforms}
    return build_camera_batch(transforms, intr, masks=masks, device=device)


def blend_inputs(g, cam, cfg, **modes):
    """K1's inputs for one camera, built by the port's own stages (surface on)."""
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess

    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True,
                                 **modes)
    return prep, args, kw


def k1_bound(args, kw, res):
    """(bound_ms, bound_by) of one K1 call: the larger of the bytes it must
    move over HBM_BYTES_PER_S and its float operations over
    FP32_FLOPS_PER_S, counted from this call's data.  Pairs: per tile the
    chunks the blend entered x run_chunk, capped at the tile's count (the
    surface pass: the same, or the whole count without surface_compact),
    times 256 pixels.  That counts every pixel of an entered chunk, done or
    not, while the kernel skips a warp's pairs once its 32 pixels are done
    and a pixel's blend arithmetic once it is done, so a kernel can come
    close to this bound, or pass it, without running at the card's rate
    (k1_share says so above 80%).  Bytes, each read or written once: the gids of the
    pairs read, the table rows of the Gaussians they name, starts / counts /
    chunks per tile, the mask and the init_trans / ed_override maps, the
    image (12 B), depth, inverse depth, final and live T per pixel, and 12 B
    of per-Gaussian key and surface distance."""
    import torch

    table, sorted_gid, starts, counts, mask = args
    counts, starts = counts.long(), starts.long()
    blend = torch.minimum(res.chunks.long() * kw["run_chunk"], counts)
    surf = torch.zeros_like(blend)
    if kw["with_surface"]:
        surf = blend if kw["surface_compact"] else counts
    flops = TPX * (K1_BLEND_FLOPS * int(blend.sum()) + K1_SURF_FLOPS * int(surf.sum()))
    read = torch.maximum(blend, surf)
    delta = torch.zeros(sorted_gid.shape[0] + 1, dtype=torch.long, device=starts.device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, starts + read, -torch.ones_like(starts))
    pairs = sorted_gid[torch.cumsum(delta, 0)[:-1] > 0].long()
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    seen[pairs] = True
    npx = kw["width_pad"] * kw["height_pad"]
    maps = sum(kw.get(k) is not None for k in ("init_trans", "ed_override"))
    n_bytes = (4 * pairs.numel() + 4 * table.shape[1] * int(seen.sum())
               + 12 * starts.numel() + npx * ((mask is not None) + 4 * maps + 28)
               + 12 * table.shape[0])
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def k2_bound(prep, n_pairs: int):
    """(bound_ms, bound_by) of K2 in full-rect mode, counted from pairs.cu's
    arguments: per Gaussian xy 8 B, r_alpha_sq 4, rect_min 8, rect_max 8,
    valid 1 and depth 4 read once; per pair an int64 key and an int32 gid
    written.  Full-rect mode runs no circle test, so no float operations
    bound it.  This is the count the benchmark's k2_roofline_pct keeps
    (benchmarks/gsbench/roofline.py, held to this function by its tests):
    the depth-first K2 reads order in depth's place and writes an int32
    tile id in the key's, 8 B a pair, so the bound is 4 B a pair high."""
    n_bytes = 33 * prep.xy.shape[0] + 12 * n_pairs
    return 1e3 * n_bytes / HBM_BYTES_PER_S, "bytes"


def check_k2(prep, cfg, circle_cull: bool, label: str) -> int:
    """Hold the depth sort and K2 to their twins before the tile sort (the
    same order, the same pair at the same index), and order_pairs to the
    twin chain (the int64 key sort and gid gather: sorted gids, tile starts
    and runs); fail on any difference, return the pair count."""
    import torch

    from gs2pc_torch.ops import rasterize as R

    order = R.depth_order(prep.depth, prep.valid)
    cpu = type(prep)(*(t.cpu() for t in prep))
    if not torch.equal(order.cpu(), R.depth_order(cpu.depth, cpu.valid)):
        fail(f"the depth sort disagrees with its twin ({label})")
    ut, ug = R.duplicate_with_keys(prep, cfg, circle_cull, order)
    tt, tg = R.duplicate_with_keys(cpu, cfg, circle_cull, order.cpu())
    torch.cuda.synchronize()
    if not (torch.equal(ut.cpu(), tt) and torch.equal(ug.cpu(), tg)):
        fail(f"K2 disagrees with its twin before the tile sort ({label}): "
             f"{ut.numel()} vs {tt.numel()} pairs")
    st, sg = R.order_pairs(prep, cfg, circle_cull)
    tk, tg = R.sort_pairs(*R.duplicate_with_keys_torch(prep, cfg, circle_cull))
    ranges = R.tile_ranges(st, cfg.num_tiles)
    want = R.tile_ranges((tk >> 32).to(torch.int32), cfg.num_tiles)
    torch.cuda.synchronize()
    if not (torch.equal(sg, tg) and all(torch.equal(a, b) for a, b in zip(ranges, want))):
        fail(f"order_pairs disagrees with the int64 key sort ({label})")
    return ut.numel()


def phase_k2(device):
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess
    from gs2pc_torch.utils import capture

    g = scene_on_device(capture.make_scene_arrays(200_000, seed=1), device)
    cams = camera_batch(1, E2E_WIDTH, E2E_HEIGHT, device, with_masks=False)
    cam = cams.at(0)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    n_pairs = []
    for surface in (True, False):
        prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                          adaptive_radius=not surface)
        n_pairs.append(check_k2(prep, cfg, not surface, f"200k Gaussians, surface={surface}"))
    print(f"K2 vs twin: 200k Gaussians, 1280x720: tile ids and gids equal exactly before the "
          f"tile sort, and after it the int64 key sort's order ({n_pairs[0]} pairs full-rect, "
          f"{n_pairs[1]} pairs circle-culled)", flush=True)


def compare_k1(k, t, label: str) -> float:
    """Hold K1's outputs ``k`` against its twin's ``t``; print one line, fail
    on any miss, return the largest float difference."""
    import numpy as np
    import torch

    from gs2pc_torch.ops.blend import FLOAT_MAX

    errs = {
        name: float((getattr(k, name) - getattr(t, name)).abs().max())
        for name in ("image", "depth", "invdepth", "trans", "contrib")
    }
    fin_k, fin_t = k.surf_dist < FLOAT_MAX, t.surf_dist < FLOAT_MAX
    n_fin_diff = int((fin_k != fin_t).sum())
    d_surf = (k.surf_dist - t.surf_dist)[fin_k & fin_t].abs()
    errs["surf_dist"] = float(d_surf.max()) if d_surf.numel() else 0.0
    hit = (k.contrib > 0) | (t.contrib > 0)
    bk = k.image.reshape(-1, 3)[k.best_pix][hit]
    bt = t.image.reshape(-1, 3)[t.best_pix][hit]
    off = int(((bk - bt).abs().amax(dim=1) > TOL_BEST).sum())
    n_hit = int(hit.sum())
    chunks_equal = torch.equal(k.chunks, t.chunks)
    bounds = dict(image=TOL_IMAGE, depth=TOL_IMAGE, invdepth=TOL_IMAGE, trans=TOL_IMAGE,
                  contrib=TOL_CONTRIB, surf_dist=TOL_SURF)
    shown = " ".join(f"{n}={v:.3g}(<={bounds[n]:g})" for n, v in errs.items())
    print(f"K1 vs twin, {label}: {shown} surf_dist finite on different Gaussians: "
          f"{n_fin_diff}; best_colour off on {off}/{n_hit} Gaussians "
          f"(<= {1 - BEST_SHARE:.1%}); chunks entered equal: {chunks_equal}", flush=True)
    if n_fin_diff:
        fail(f"K1 surface distances finite on different Gaussians ({label})")
    for n, v in errs.items():
        if not np.isfinite(v) or v > bounds[n]:
            fail(f"K1 {n} differs from its twin by {v} > {bounds[n]} ({label})")
    if n_hit == 0 or off > (1 - BEST_SHARE) * n_hit:
        fail(f"K1 best colour differs on {off}/{n_hit} Gaussians ({label})")
    if not chunks_equal:
        fail(f"K1 entered other chunks than its twin ({label})")
    return max(errs.values())


def phase_k1(device):
    import numpy as np
    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops.rasterize import TileConfig
    from gs2pc_torch.utils import capture

    g = scene_on_device(capture.make_scene_arrays(20_000, seed=2), device)
    cams = camera_batch(1, 256, 192, device, with_masks=True)
    cam = cams.at(0)
    npx = cams.width_pad * cams.height_pad
    r = np.random.default_rng(3)
    t0 = r.uniform(0.0, 1.0, npx).astype(np.float32)
    t0[r.uniform(size=npx) < 0.1] = 1e-5
    t0 = torch.tensor(t0, device=device)
    ed = torch.tensor(r.uniform(4.0, 7.0, npx).astype(np.float32), device=device)
    cases = [(True, True, {}), (False, True, {}), (True, False, {})]
    for compact in (True, False):
        cases += [
            (compact, True, dict(early_stop=False)),
            (compact, True, dict(init_trans=t0)),
            (compact, True, dict(init_trans=t0, ed_override=ed)),
            (compact, False, dict(ed_override=ed)),
        ]
    for compact, surface_compact, modes in cases:
        cfg = TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                         compact=compact, surface_compact=surface_compact)
        _, args, kw = blend_inputs(g, cam, cfg, **modes)
        k = B.blend_tiles(*args, **kw)
        t = B.blend_tiles_torch(*args, **kw)
        torch.cuda.synchronize()
        mode = B.mode_of(modes.get("init_trans"), modes.get("ed_override"),
                         modes.get("early_stop", True))
        compare_k1(k, t, f"20k Gaussians 256x192, {mode} (maps: {sorted(modes)}), "
                         f"compact={compact} surface_compact={surface_compact}")


def read_ply_count(path: str) -> int:
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.decode("ascii", "replace").strip()
            if line.startswith("element vertex"):
                return int(line.split()[-1])
            if line == "end_header":
                break
    fail(f"{path} has no vertex count")
    return -1


def mahalanobis_max(cloud, arrays, n_check=200_000) -> float:
    """Largest |z| = |diag(exp -s) R^T (x - mean)| over a sample of points."""
    import numpy as np

    from gs2pc_torch.models.gaussians import PSD_LOG_FLOOR

    rng = np.random.default_rng(0)
    idx = rng.choice(cloud.total, size=min(n_check, cloud.total), replace=False)
    gid = cloud.gauss_ids()[idx]
    q = arrays.rots[gid].astype(np.float64)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)
    d = cloud.points[idx].astype(np.float64) - arrays.xyz[gid]
    scales = np.exp(np.maximum(arrays.log_scales[gid], PSD_LOG_FLOOR))
    local = np.einsum("nji,nj->ni", R, d) / scales
    return float(np.sqrt((local ** 2).sum(-1)).max())


def check_cloud(result, out: str, label: str) -> int:
    """Points written == cloud == quota sum, all finite; returns the count."""
    import numpy as np

    cloud = result.cloud
    n_file = read_ply_count(out)
    quota_sum = int(cloud.counts.sum())
    if not (n_file == cloud.total == quota_sum):
        fail(f"{label}: points written {n_file}, cloud {cloud.total}, quota sum {quota_sum}")
    if not np.isfinite(cloud.points).all():
        fail(f"{label}: non-finite point positions")
    # A lazy cloud (its points on the card) streams through the native
    # session; an eager one (after --clean_pointcloud) is expanded at once.
    want = "native_stream" if hasattr(cloud, "stream_chunks") else "native_expand"
    if result.writer != want:
        fail(f"{label}: the PLY was written by the {result.writer} writer, not {want}")
    return n_file


def reset_launches() -> None:
    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import plydecode
    from gs2pc_torch.ops import projection as PJ
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops import sampler as S
    from gs2pc_torch.parallel import launch

    plydecode.ply_decode.launches = 0
    B.blend_tiles.launches = 0
    R.duplicate_with_keys.launches = 0
    R.order_pairs.launches = 0
    S.sample_points.launches = 0
    PJ.project_and_pack.launches = 0
    PJ.preprocess.launches = 0
    PJ.preprocess_torch.calls = 0
    launch.RANK_LAUNCHES.clear()


def read_launches() -> dict:
    """K1's, K2's, the key sorts', K5's, K6's and the record decode's launches since
    reset_launches(), this
    process's and those of the ranks it spawned (one process per card of a
    multi-card conversion) together (K6's: "project_and_pack" with its
    table, "preprocess" without); and this process's calls of K6's twin
    ("preprocess_torch")."""
    from gs2pc_torch.ops import projection as PJ
    from gs2pc_torch.parallel import launch

    total = launch.kernel_launches()
    for counts in launch.RANK_LAUNCHES.values():
        for name in total:
            total[name] += counts[name]
    total["preprocess_torch"] = PJ.preprocess_torch.calls
    return total


def launches_by_rank() -> list:
    """[K1, K2, K5] launches of each rank since reset_launches(), rank 0
    (this process) first."""
    from gs2pc_torch.parallel import launch

    ranks = [launch.kernel_launches()] + [launch.RANK_LAUNCHES[r]
                                          for r in sorted(launch.RANK_LAUNCHES)]
    return [[c["blend_tiles"], c["duplicate_with_keys"], c["sample_points"]] for c in ranks]


def cli_ranks(sweeps: bool = True) -> int:
    """The processes a CLI conversion at the default --num_devices runs:
    one per card when it sweeps, one without a sweep."""
    import torch

    return torch.cuda.device_count() if sweeps else 1


def conversion_launches(n_cams: int, samplings: int, sweeps: bool = True,
                        decoded: int = 0) -> dict:
    """K1, K2, key sort, K5, K6 and record decode launches of a CLI
    conversion over all its ranks: one K1, two K2, two sorts and one K6
    (with its table) a camera, one K5 a sampling on every rank, one decode
    a block of the ``decoded`` rows of an export the card decodes (rank 0's
    load); no K6 without a table and no call of K6's twin."""
    from gs2pc_torch.io.gaussians_io import CARD_BLOCK_ROWS

    return {"blend_tiles": n_cams, "duplicate_with_keys": 2 * n_cams, "order_pairs": 2 * n_cams,
            "sample_points": samplings * cli_ranks(sweeps), "project_and_pack": n_cams,
            "preprocess": 0, "ply_decode": -(-decoded // CARD_BLOCK_ROWS), "preprocess_torch": 0}


def e2e_argv(ply, tj, mask_dir, out, n_points=None):
    return ["--input_path", ply, "--transform_path", tj, "--mask_path", mask_dir,
            "--output_path", out, "--num_points", str(n_points or N_POINTS), "--seed", "0",
            "--quiet"]


def phase_e2e(device, work):
    from gs2pc_torch import cli
    from gs2pc_torch.utils import capture, log

    t0 = time.perf_counter()
    arrays = capture.make_scene_arrays(N_E2E_GAUSSIANS)
    transforms, intr = capture.make_poses(N_E2E_CAMERAS, E2E_WIDTH, E2E_HEIGHT)
    ply, tj, mask_dir = capture.write_capture(work, arrays, transforms, intr, with_masks=True)
    print(f"e2e capture written in {time.perf_counter() - t0:.1f}s "
          f"({N_E2E_GAUSSIANS} Gaussians, {N_E2E_CAMERAS} cameras)", flush=True)

    def argv(out):
        return e2e_argv(ply, tj, mask_dir, out) + ["--surface_distance_std", "1e6"]

    out = os.path.join(work, "cloud.ply")

    log.reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    result = cli.main(argv(out))
    wall = time.perf_counter() - t0
    launches = read_launches()

    want = conversion_launches(N_E2E_CAMERAS, 1)
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")
    n_file = check_cloud(result, out, "e2e")
    if abs(n_file - N_POINTS) > 0.01 * N_POINTS:
        fail(f"{n_file} points written for a budget of {N_POINTS}")
    zmax = mahalanobis_max(result.cloud, arrays)
    if zmax > 2.0 + 1e-3:
        fail(f"a sampled point lies {zmax} deviations from its Gaussian (> 2)")
    phases = {k: round(v, 3) for k, v in log.PHASE_SECONDS.items()}
    print(f"e2e: {n_file} points (quota sum {int(result.cloud.counts.sum())}) in {wall:.2f}s, "
          f"{n_file / wall:,.0f} points/s disk to disk; writer {result.writer}; "
          f"launches {launches}; counters [pairs, win_drop, cap_drop, cap_live] = "
          f"{result.sweep_diag[:4]}; max sampled |z| {zmax:.4f}; point_sampling "
          f"{phases['point_sampling']:.3f}s with K5 (before K5: {PARENT_POINT_SAMPLING_S}s, "
          f"PERF.md §5); phases {json.dumps(phases)}", flush=True)

    os.remove(out)
    return arrays, launches, dict(ply=ply, tj=tj, masks=mask_dir, cols_u8=result.cloud.cols_u8,
                                  cloud=result.cloud, phases=phases)


def phase_transfers(device, work, e2e, smi: str) -> None:
    """The host transfers on the e2e scene's 10M-point cloud: its PLY
    written through the stream (pinned chunks, the native session), through
    the eager route the port took before (a pageable fetch of the whole
    point buffer, then gs2pc_write_ply_expand) and by that writer alone on
    points already on the host, five times each in turns, byte-equal;
    the fetch alone, pageable and pinned; the e2e phases beside the eager
    port's; and one CLI conversion under torch.profiler, its copies by kind and
    phase: it fails on any pageable device-to-host copy of the point buffer
    (the whole buffer's or a chunk's size, or any in ply_write) and when
    ply_write made no pinned one; the bytes the write fetched and those of
    the scene's planes uploaded from pinned memory are printed."""
    import numpy as np
    import torch

    from gs2pc_torch import cli
    from gs2pc_torch.io.ply import PointCloud, save_point_cloud_ply
    from gs2pc_torch.pipeline import LazyPointCloud
    from gs2pc_torch.tools.bench_kernels import trace_copies, trace_phases
    from gs2pc_torch.utils import log

    cloud = e2e["cloud"]
    if not isinstance(cloud, LazyPointCloud) or cloud.device_points.device.type != "cuda":
        fail("transfers: the e2e conversion's cloud is not a lazy cloud on the card")
    lazy = os.path.join(work, "stream.ply")
    eager = os.path.join(work, "eager.ply")

    host_points = cloud.device_points.cpu().numpy()

    def stream():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer = save_point_cloud_ply(cloud, lazy, chunk_size=10**6)
        return time.perf_counter() - t0, writer, "native_stream"

    def eager_route():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = cloud.device_points.cpu().numpy()
        writer = save_point_cloud_ply(PointCloud(pts, cloud.counts, cloud.cols_u8,
                                                 cloud.gauss_normals), eager, chunk_size=10**6)
        return time.perf_counter() - t0, writer, "native_expand"

    def write_only():
        t0 = time.perf_counter()
        writer = save_point_cloud_ply(PointCloud(host_points, cloud.counts, cloud.cols_u8,
                                                 cloud.gauss_normals), eager, chunk_size=10**6)
        return time.perf_counter() - t0, writer, "native_expand"

    # Five of each, the order turned every round (the disk's spread is wide).
    walls = {"stream": [], "eager_route": [], "write_only": []}
    for i in range(5):
        for fn in (stream, eager_route, write_only)[::1 if i % 2 == 0 else -1]:
            wall, writer, want = fn()
            walls[fn.__name__].append(round(wall, 4))
            if writer != want:
                fail(f"transfers: {fn.__name__} wrote through {writer}, not {want}")
            if fn is not stream and not files_equal(lazy, eager):
                fail(f"transfers: the streamed PLY differs from {fn.__name__}'s")
    del host_points
    size = os.path.getsize(lazy)
    os.remove(lazy)
    os.remove(eager)

    src = cloud.device_points
    n_bytes = src.numel() * 4

    def fetch_pageable():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src.cpu()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    pinned = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    alloc_s = time.perf_counter() - t0

    def fetch_pinned():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def fetch_chunks():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in cloud.point_rows(10**6):
            pass
        return time.perf_counter() - t0

    fetch = {name: [round(fn() * 1e3, 3) for _ in range(3)]
             for name, fn in (("pageable", fetch_pageable), ("pinned", fetch_pinned),
                              ("pinned_chunks", fetch_chunks))}
    if not np.array_equal(pinned.numpy(), src.cpu().numpy()):
        fail("transfers: the pinned fetch differs from the pageable one")
    del pinned

    out = os.path.join(work, "profiled.ply")
    argv = e2e_argv(e2e["ply"], e2e["tj"], e2e["masks"], out) + ["--surface_distance_std", "1e6"]
    trace = os.path.join(work, "transfers_trace.json")
    log.reset_phases()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = cli.main(argv)
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    check_cloud(res, out, "transfers (profiled CLI)")
    os.remove(out)
    copies = trace_copies(trace, list(log.PHASE_SECONDS))
    breakdown = trace_phases(trace)
    os.remove(trace)
    if not copies:
        fail("transfers: the profiler recorded no device copies")
    total = res.cloud.total
    kinds = {}
    for kind, b, ms, phase in copies:
        k = kinds.setdefault(kind, {"count": 0, "bytes": 0, "ms": 0.0, "by_phase": {}})
        k["count"] += 1
        k["bytes"] += b
        k["ms"] = round(k["ms"] + ms, 3)
        k["by_phase"][str(phase)] = k["by_phase"].get(str(phase), 0) + b
    mine = {k: round(e2e["phases"].get(k, 0.0), 3) for k in PARENT_TRANSFER_PHASES}
    # Reported, not gated: one profiled run (of several) lacked one plane's
    # record, though the copies are the same every run.
    write_d2h = sum(b for kind, b, _, phase in copies if "DtoH" in kind and phase == "ply_write")
    h2d_pinned = sum(b for kind, b, _, phase in copies
                     if kind.endswith("(Pinned -> Device)") and phase == "scene_parse")
    print(f"transfers ({smi}): {total} points, {size} bytes; PLY walls [s] streamed "
          f"{walls['stream']}, eager route (pageable fetch + native_expand) "
          f"{walls['eager_route']}, native_expand of points already on the host "
          f"{walls['write_only']}, all byte-equal; fetch of the {n_bytes}-byte point buffer "
          f"alone [ms] "
          f"{json.dumps(fetch)} (the pinned buffer's allocation {alloc_s * 1e3:.3f} ms); e2e "
          f"phases {json.dumps(mine)} against the eager port's "
          f"{json.dumps(PARENT_TRANSFER_PHASES)} "
          f"(PERF.md §5); profiled CLI copies by kind and phase {json.dumps(kinds)}: ply_write "
          f"{write_d2h} bytes to the host of the {12 * total}-byte buffer, the scene's planes "
          f"{h2d_pinned} bytes from pinned memory during the parse of their "
          f"{14 * 4 * N_E2E_GAUSSIANS}; its phases {json.dumps(breakdown)}", flush=True)
    point_sizes = {12 * total, 12 * min(10**6, total), 12 * (total % 10**6)} - {0}
    for kind, b, _, phase in copies:
        if "DtoH" in kind and "Pageable" in kind and (b in point_sizes or phase == "ply_write"):
            fail(f"transfers: a pageable device-to-host copy of {b} bytes in {phase}: "
                 "the point buffer crossed pageable")
    if not any(kind.endswith("(Device -> Pinned)") and phase == "ply_write"
               for kind, _, _, phase in copies):
        fail("transfers: ply_write made no pinned device-to-host copy")


def k1_share(ms: float, bound) -> str:
    """The share of its bound a K1 time reads, with k1_bound's caveat above 80%."""
    share = bound[0] / ms
    note = (" (over 80%: the bound counts all 256 pixels of every entered chunk, the "
            "kernel skips done warps)" if share > 0.8 else "")
    return f"{share:.1%} of the bound{note}"


def phase_timing(device, arrays):
    """K1 and K2 on camera 0 of the e2e scene, the shape the main path gives
    them: outputs held against the twins, then timed, launch alone (the C
    entry point replayed on the wrapper's arguments) and through the
    wrapper."""
    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.tools.bench_kernels import K1_ENTRY, K2_ENTRIES, launch_ms

    g = scene_on_device(arrays, device)
    cams = camera_batch(1, E2E_WIDTH, E2E_HEIGHT, device, with_masks=True)
    cam = cams.at(0)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                       compact=True, surface_compact=True)
    prep, args, kw = blend_inputs(g, cam, cfg)
    n_pairs = int(args[1].numel())
    label = f"camera 0 of the e2e scene ({n_pairs} pairs)"

    check_k2(prep, cfg, False, label)
    print(f"K2 vs twin, {label}: tile ids and gids equal exactly before the tile sort, and "
          f"after it the int64 key sort's order", flush=True)

    k = B.blend_tiles(*args, **kw)
    t = B.blend_tiles_torch(*args, **kw)
    torch.cuda.synchronize()
    k1_err = compare_k1(k, t, label)
    bounds = {"blend_tiles": k1_bound(args, kw, k),
              "duplicate_with_keys": k2_bound(prep, n_pairs)}
    ch = k.chunks.double()
    print(f"K1 chunks entered per tile, {label}: mean {float(ch.mean()):.3f}, p99 "
          f"{float(torch.quantile(ch, 0.99)):.1f}, max {int(ch.max())} (run_chunk "
          f"{kw['run_chunk']}, {int((ch > 0).sum())} of {ch.numel()} tiles entered)", flush=True)
    del k, t

    order = R.depth_order(prep.depth, prep.valid)

    def k2():
        return R.duplicate_with_keys(prep, cfg, False, order)

    def k1():
        return B.blend_tiles(*args, **kw)

    k2_launch = launch_ms(k2, K2_ENTRIES, 10)
    ms = {
        "duplicate_with_keys": cuda_ms(k2, 5),
        "duplicate_with_keys_torch": cuda_ms(lambda: R.duplicate_with_keys_torch(prep, cfg, False),
                                             2),
        "blend_tiles_launch": launch_ms(k1, [K1_ENTRY], 10)[K1_ENTRY],
        "blend_tiles": cuda_ms(k1, 5),
        "blend_tiles_torch": cuda_ms(lambda: B.blend_tiles_torch(*args, **kw), 1),
        "k2_count": k2_launch[K2_ENTRIES[0]],
        "k2_write": k2_launch[K2_ENTRIES[1]],
        "order_pairs": cuda_ms(lambda: R.order_pairs(prep, cfg, False), 5),
    }
    ms["k2_scan_sync"] = ms["duplicate_with_keys"] - ms["k2_count"] - ms["k2_write"]
    print(f"timing, {label}: K1 launch alone {ms['blend_tiles_launch']:.4f} ms, through the "
          f"wrapper {ms['blend_tiles']:.4f} ms, twin {ms['blend_tiles_torch']:.1f} ms, bound "
          f"{bounds['blend_tiles'][0]:.4f} ms ({bounds['blend_tiles'][1]}), "
          f"{k1_share(ms['blend_tiles_launch'], bounds['blend_tiles'])}; K2 count "
          f"{ms['k2_count']:.4f} ms, scan + sync {ms['k2_scan_sync']:.4f} ms, write "
          f"{ms['k2_write']:.4f} ms, through the wrapper {ms['duplicate_with_keys']:.4f} ms, twin "
          f"{ms['duplicate_with_keys_torch']:.3f} ms, bound "
          f"{bounds['duplicate_with_keys'][0]:.4f} ms (bytes); the depth sort, K2 and the tile "
          f"sort through order_pairs {ms['order_pairs']:.4f} ms", flush=True)
    return ms, bounds, k1_err


def k5_bound_all_draw(n_gaussians: int, n_points: int):
    """(bound_ms, bound_by) of one K5 call counted as if every slot drew:
    every slot, centres too, runs four threefry blocks and floats from
    their bits, three erf_inv with their log1pf and sqrtf, the CDF at the
    bound and the 26 bisection rounds with their erff and expf, an owner
    search of the whole prefix (ceil(log2(P + 1)) probes), three expf of
    the scales, a sqrtf and a division, and the rest.  Bytes as
    k5_bound."""
    import math

    libm = K5_LIBM_OPS
    cdf = K5_CDF_OPS + libm["erff"] + libm["expf"]
    per_point = (4 * (K5_THREEFRY_OPS + K5_FLOAT_OPS)
                 + 3 * (K5_ERFINV_OPS + libm["log1pf"] + libm["sqrtf"])
                 + cdf + K5_BISECT_ROUNDS * (K5_BISECT_OPS + cdf)
                 + K5_SEARCH_OPS * math.ceil(math.log2(n_gaussians + 1))
                 + 3 * libm["expf"] + libm["sqrtf"] + libm["div"] + K5_REST_OPS)
    return _bound(48 * n_gaussians + 20 * n_points, per_point * n_points)


def k5_bound(n_gaussians: int, n_points: int, drawn: int, owners: int, layout: dict):
    """(bound_ms, bound_by) of one K5 call over ``n_points`` slots of
    ``n_gaussians``, counted from this call's quotas: ``drawn`` slots are
    not their Gaussian's centre, ``owners`` Gaussians own a slot, and
    ``layout`` is the kernel's (gs2pc_sample_points_layout: CTAs, table
    levels L, tile).  Bytes, each read or written once: the int64 quota
    prefix and xyz, log_scales, rots (48 B a Gaussian); each point's xyz and
    int64 gid (20 B).  Operations (the K5_* constants): every slot its owner
    (a search of its tile's window, log2(tile) probes) and its scale,
    rotation and mean; a drawn slot four threefry blocks and floats from
    their bits, three erf_inv with their log1pf and sqrtf, L table levels
    (a compare and a midpoint each) and 26 - L bisection rounds with their
    erff and expf, a sqrtf, a division and its direction; an owner three
    expf of its scales; a CTA its table (2^L - 1 CDFs and midpoints) and
    the CDF at the bound.  A centre draws nothing, and the table's CDFs are
    counted once a CTA, not once a point (k5_bound_all_draw counts both for every
    slot)."""
    import math

    libm = K5_LIBM_OPS
    cdf = K5_CDF_OPS + libm["erff"] + libm["expf"]
    levels = layout["table_levels"]
    every_slot = K5_SEARCH_OPS * math.ceil(math.log2(layout["tile"])) + K5_STORE_OPS
    per_drawn = (4 * (K5_THREEFRY_OPS + K5_FLOAT_OPS)
                 + 3 * (K5_ERFINV_OPS + libm["log1pf"] + libm["sqrtf"])
                 + levels * K5_BISECT_OPS + (K5_BISECT_ROUNDS - levels) * (K5_BISECT_OPS + cdf)
                 + libm["sqrtf"] + libm["div"] + K5_DIRECTION_OPS)
    per_cta = ((1 << levels) - 1) * (cdf + K5_BISECT_OPS) + cdf
    ops = (every_slot * n_points + per_drawn * drawn + 3 * libm["expf"] * owners
           + per_cta * layout["ctas"])
    return _bound(48 * n_gaussians + 20 * n_points, ops)


def k6_bound(n_gaussians: int, lanes: int):
    """(bound_ms, bound_by) of one K6 call over ``n_gaussians`` with a table
    of ``lanes`` lanes (0: preprocess alone).  Bytes, each read or written
    once: the mean, the factor, the opacity and the alive flag (53 B a
    Gaussian), with a table the colour (12 B); the Preprocessed fields that
    are not inputs (depth, xy, conic, the three radii: 36 B; the rects and
    tiles_touched: 20 B; valid: 1 B) and the row (4 B a lane); the camera's
    two matrices and four scalars (144 B) once.  Operations: K6_OPS a
    Gaussian, K6_COMPACT_OPS more for a compact row."""
    per = 53 + 57 + (12 + 4 * lanes if lanes else 0)
    ops = K6_OPS + (K6_COMPACT_OPS if lanes == 8 else 0)
    return _bound(per * n_gaussians + 144, ops * n_gaussians)


def _bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k5_layout(n_points: int) -> dict:
    """K5's grid for a call over ``n_points`` slots on the current card, its
    table levels and tile (the kernel's own constants)."""
    import ctypes

    from gs2pc_torch.ops import cuda_build

    got = [ctypes.c_int(0) for _ in range(3)]
    rc = cuda_build.load_library().gs2pc_sample_points_layout(
        n_points, *(ctypes.addressof(v) for v in got))
    cuda_build.check(rc, "gs2pc_sample_points_layout")
    return dict(zip(("ctas", "table_levels", "tile"), (v.value for v in got)))


def phase_k5(device, arrays):
    """K5 at the e2e cell's width: the e2e scene (3M Gaussians, the PSD
    clamp applied) and 10M points of quotas by size, key PRNGKey(0); held
    to its twin run on the card and the blocks of a 2- and 4-way split on
    one card to the whole range, bit for bit; then timed, launch alone and
    through the wrapper, beside the twin and the bound (recounted from the
    quotas, the all-draw count beside it)."""
    import torch

    from gs2pc_torch.ops import cuda_build, prng
    from gs2pc_torch.ops import sampler as S
    from gs2pc_torch.parallel.mesh import split_evenly
    from gs2pc_torch.tools.bench_kernels import kernel_ptxas, launch_ms

    g = scene_on_device(arrays, device).validate_covariances()
    ppg = S.distribute_points(g.magnitudes(), N_POINTS)
    n_cap = N_POINTS + max(4096, N_POINTS // 20)
    key = prng.PRNGKey(0)
    prefix, n = S.slot_prefix(ppg, n_cap)
    # Each Gaussian with a quota whose run starts below n owns slots and
    # has its centre among them; every other slot draws.
    owners = int(((prefix - ppg < n) & (ppg > 0)).sum())
    drawn = n - owners
    label = f"{g.num_gaussians} Gaussians, {n} points"

    k = S.sample_points(key, g, ppg, n_cap)
    t = S.sample_points_torch(key, g, ppg, n_cap)
    torch.cuda.synchronize()
    if k.points.shape != (n, 3) or not torch.isfinite(k.points).all():
        fail(f"K5, {label}: points of shape {tuple(k.points.shape)}, or not finite")
    if not torch.equal(k.gaussian_idx, t.gaussian_idx):
        fail(f"K5, {label}: the owners differ from the twin's")
    differ = int((k.points != t.points).any(dim=1).sum())
    err = float((k.points - t.points).abs().max())
    if err > TOL_K5:
        fail(f"K5, {label}: {differ} points differ from the twin's, max |err| {err}")
    for parts in (2, 4):
        blocks = [S.sample_points(key, g, ppg, n_cap, block=b).points
                  for b in split_evenly(n, parts)]
        if not torch.equal(torch.cat(blocks), k.points):
            fail(f"K5, {label}: the {parts} blocks differ from the whole range")
        del blocks
    print(f"K5 vs twin, {label} ({owners} centres, {drawn} slots that draw): owners equal, "
          f"{differ} points differ, max |err| {err}; the 2- and 4-block splits equal the whole "
          f"range bit for bit", flush=True)
    del k, t

    def k5():
        return S.sample_points(key, g, ppg, n_cap)

    layout = k5_layout(n)
    ms = dict(
        launch_ms=launch_ms(k5, ["gs2pc_sample_points"], 10)["gs2pc_sample_points"],
        wrapper_ms=cuda_ms(k5, 5),
        plain_ms=cuda_ms(lambda: S.sample_points_torch(key, g, ppg, n_cap), 1),
        bound=k5_bound(g.num_gaussians, n, drawn, owners, layout),
        bound_all_draw=k5_bound_all_draw(g.num_gaussians, n), max_abs_err=err, layout=layout,
        ptxas=kernel_ptxas(cuda_build.BUILD_INFO.get("log", ""), "sample_points_kernel")
        or "the library was built before this run",
    )
    print(f"timing, K5, {label}: launch alone {ms['launch_ms']:.4f} ms, through the wrapper "
          f"{ms['wrapper_ms']:.4f} ms, twin {ms['plain_ms']:.3f} ms, bound "
          f"{ms['bound'][0]:.4f} ms ({ms['bound'][1]}), "
          f"{ms['bound'][0] / ms['launch_ms']:.1%} of the bound (counted as if every slot drew "
          f"{ms['bound_all_draw'][0]:.4f} ms, {ms['bound_all_draw'][0] / ms['launch_ms']:.1%}); "
          f"{layout['ctas']} CTAs of tiles of {layout['tile']} slots, {layout['table_levels']} "
          f"table levels; ptxas: {ms['ptxas']}", flush=True)
    return ms


def k6_twin(means, factors, opacities, alive, colours, cam, cfg, adaptive):
    """K6's plain twin: preprocess_torch + pack_blend_table."""
    from gs2pc_torch.ops import projection as PJ
    from gs2pc_torch.ops import rasterize as R

    prep = PJ.preprocess_torch(means, factors, opacities, alive, cam, adaptive)
    return prep, R.pack_blend_table(prep, colours, compact=cfg.compact)


def k6_differ(a, b) -> dict:
    """{field: elements that differ bit for bit} between two (Preprocessed,
    table) results (floats compared as their int32 bits: NaNs and signed
    zeros count), and the largest |a - b| over the finite pairs."""
    import torch

    out, err = {}, 0.0
    for name, x, y in zip(list(a[0]._fields) + ["table"], list(a[0]) + [a[1]],
                          list(b[0]) + [b[1]]):
        if x is None or y is None:
            if (x is None) != (y is None):
                out[name] = -1
            continue
        x, y = x.contiguous(), y.contiguous()
        if x.shape != y.shape or x.dtype != y.dtype:
            out[name] = -1
            continue
        bits = (x.view(torch.int32), y.view(torch.int32)) if x.is_floating_point() else (x, y)
        n = int((bits[0] != bits[1]).sum())
        if n:
            out[name] = n
        both = torch.isfinite(x.double()) & torch.isfinite(y.double())
        if both.any():
            err = max(err, float((x.double() - y.double())[both].abs().max()))
    return out, err


def phase_k6(device, arrays):
    """K6 at the e2e cell's width: camera 0 of the e2e scene (3M Gaussians,
    1280x720, its mask), both radius modes, both table layouts and the
    table-less preprocess, held to its twin run on the card bit for bit;
    then timed, launch alone and through the wrapper, beside the twin and
    the bound: the main path's call (full rect for the surface pass,
    compact) and the table-less one."""
    import torch

    from gs2pc_torch.ops import cuda_build
    from gs2pc_torch.ops import projection as PJ
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.tools.bench_kernels import K6_ENTRY, kernel_ptxas, launch_ms

    g = scene_on_device(arrays, device)
    cams = camera_batch(1, E2E_WIDTH, E2E_HEIGHT, device, with_masks=True)
    cam = cams.at(0)
    gauss = (g.xyz, g.covariance_factors(), g.opacities, g.keep_mask)
    P = g.num_gaussians
    label = f"camera 0 of the e2e scene ({P} Gaussians, {E2E_WIDTH}x{E2E_HEIGHT})"
    err, seen = 0.0, []
    for adaptive in (False, True):
        for compact in (True, False):
            cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                               compact=compact)
            k = PJ.project_and_pack(*gauss, g.colours, cam, cfg, adaptive)
            t = k6_twin(*gauss, g.colours, cam, cfg, adaptive)
            alone = PJ.preprocess(*gauss, cam, adaptive)
            torch.cuda.synchronize()
            mode = f"{'adaptive' if adaptive else 'full rect'}, {'compact' if compact else 'wide'}"
            bad, e = k6_differ(k, t)
            bad_alone, _ = k6_differ((alone, None), (t[0], None))
            if bad or bad_alone:
                fail(f"K6 vs twin, {label}, {mode}: differing elements {bad}, without the "
                     f"table {bad_alone}")
            err = max(err, e)
            seen.append(f"{mode} ({int(k[0].valid.sum())} valid)")
            del k, t, alone
    print(f"K6 vs twin, {label}: every field and the table equal bit for bit in {seen}, and "
          f"without the table; max |err| {err}", flush=True)

    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad, compact=True)

    def k6():
        return PJ.project_and_pack(*gauss, g.colours, cam, cfg, False)

    def k6_alone():
        return PJ.preprocess(*gauss, cam, False)

    ms = dict(
        launch_ms=launch_ms(k6, [K6_ENTRY], 20)[K6_ENTRY],
        wrapper_ms=cuda_ms(k6, 20),
        plain_ms=cuda_ms(lambda: k6_twin(*gauss, g.colours, cam, cfg, False), 5),
        bound=k6_bound(P, 8),
        alone_launch_ms=launch_ms(k6_alone, [K6_ENTRY], 20)[K6_ENTRY],
        alone_wrapper_ms=cuda_ms(k6_alone, 20),
        alone_plain_ms=cuda_ms(lambda: PJ.preprocess_torch(*gauss, cam, False), 5),
        alone_bound=k6_bound(P, 0), max_abs_err=err,
        ptxas=kernel_ptxas(cuda_build.BUILD_INFO.get("log", ""), "project_pack_kernel")
        or "the library was built before this run",
    )
    print(f"timing, K6, {label}, the main path's call (full rect, compact table): launch "
          f"alone {ms['launch_ms']:.4f} ms, through the wrapper {ms['wrapper_ms']:.4f} ms, twin "
          f"{ms['plain_ms']:.3f} ms, bound {ms['bound'][0]:.4f} ms ({ms['bound'][1]}), "
          f"{ms['bound'][0] / ms['launch_ms']:.1%} of the bound; without the table: alone "
          f"{ms['alone_launch_ms']:.4f} ms, through the wrapper {ms['alone_wrapper_ms']:.4f} ms, "
          f"twin {ms['alone_plain_ms']:.3f} ms, bound {ms['alone_bound'][0]:.4f} ms "
          f"({ms['alone_bound'][1]}); ptxas: {ms['ptxas']}", flush=True)
    return ms


def phase_slab(device, arrays):
    """K1's three depth-slab passes of slab 1 of 4 on camera 0 of the e2e
    scene, with the inputs the depth-slab sweep gives them (pass 2's
    starting T is slab 0's real transmittance, pass 3's depth map the real
    combined one): held against the twin, then timed beside it."""
    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.parallel.gauss_shard import render_sweep_gauss_sharded
    from gs2pc_torch.sweep import render_arrays
    from gs2pc_torch.tools.bench_kernels import K1_ENTRY, launch_ms

    g = scene_on_device(arrays, device)
    cams = camera_batch(1, E2E_WIDTH, E2E_HEIGHT, device, with_masks=True)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                       compact=True, surface_compact=True)
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return B.blend_tiles(*args, **kw)

    with mock.patch.object(R, "blend_tiles", record):
        render_sweep_gauss_sharded(render_arrays(g), cams, cfg, [device] * N_SLABS)
    if len(calls) != 3 * N_SLABS:
        fail(f"the depth-slab sweep of one camera made {len(calls)} K1 calls, "
             f"expected {3 * N_SLABS}")
    out = {}
    for mode, (args, kw) in zip(K1_MODES, calls[1::N_SLABS]):
        if B.mode_of(kw["init_trans"], kw["ed_override"], kw["early_stop"]) != mode:
            fail(f"slab pass {mode} ran K1 in another mode")
        label = f"slab 1 of {N_SLABS}, camera 0 of the e2e scene, {mode} ({args[1].numel()} pairs)"
        k = B.blend_tiles(*args, **kw)
        t = B.blend_tiles_torch(*args, **kw)
        torch.cuda.synchronize()
        err = compare_k1(k, t, label)
        bound = k1_bound(args, kw, k)
        del k, t
        ms = launch_ms(lambda: B.blend_tiles(*args, **kw), [K1_ENTRY], 10)[K1_ENTRY]
        wrapped = cuda_ms(lambda: B.blend_tiles(*args, **kw), 5)
        plain = cuda_ms(lambda: B.blend_tiles_torch(*args, **kw), 1)
        print(f"timing, {label}: K1 launch alone {ms:.4f} ms, through the wrapper "
              f"{wrapped:.4f} ms, twin {plain:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
              f"{k1_share(ms, bound)}", flush=True)
        out[mode] = dict(max_abs_err=err, launch_ms=ms, wrapper_ms=wrapped, plain_ms=plain,
                         bound=bound)
    return out


def shard_diffs(acc, ref) -> dict:
    """Largest differences of a sharded sweep's accumulators from a
    single-device reference."""
    from gs2pc_torch.ops.blend import FLOAT_MAX

    fa, fr = acc.min_surface_distance < FLOAT_MAX, ref.min_surface_distance < FLOAT_MAX
    d_sd = (acc.min_surface_distance - ref.min_surface_distance)[fa & fr].abs()
    d_max = (acc.max_contribution - ref.max_contribution).abs()
    return dict(
        max_contribution=float(d_max.max()),
        over_bound=int((d_max > TOL_SHARD_CONTRIB).sum()),
        total_contribution=float((acc.total_contribution - ref.total_contribution).abs().max()),
        surf_dist=float(d_sd.max()) if d_sd.numel() else 0.0,
        surf_finite_differs=int((fa != fr).sum()),
        colour_share=float(((acc.colours - ref.colours).abs().amax(dim=1)
                            < TOL_SHARD_COLOUR).float().mean()),
    )


def compare_sharded(acc, ref, ref_sd, label: str) -> None:
    """Hold a depth-slab sweep to the single-device sweep in the same radius
    mode: contributions, colours and counters to ``ref`` (surface pass off,
    so the adaptive radius of passes 1-2), surface distances to ``ref_sd``
    (the full rect, measured against ``ref``'s expected depth, as pass 3)."""
    import torch

    d = shard_diffs(acc, ref)
    d_sd = shard_diffs(acc, ref_sd)
    print(f"{label} vs one device: max_contribution {d['max_contribution']:.3g}, total "
          f"{d['total_contribution']:.3g}, colour within {TOL_SHARD_COLOUR:g} on "
          f"{d['colour_share']:.6f}, surface distance {d_sd['surf_dist']:.3g} (finite on "
          f"different Gaussians: {d_sd['surf_finite_differs']}); counters "
          f"{acc.n_dropped.tolist()} vs {ref.n_dropped.tolist()}", flush=True)
    if float(acc.n_dropped[1]) != 0.0:
        fail(f"{label}: {float(acc.n_dropped[1])} Gaussians overflowed their slab buffers")
    if not torch.equal(acc.n_dropped, ref.n_dropped) or float(acc.n_dropped[2]) != 0.0:
        fail(f"{label}: counters {acc.n_dropped.tolist()} vs {ref.n_dropped.tolist()}")
    worst = max(d["max_contribution"], d["total_contribution"])
    if worst > TOL_SHARD_CONTRIB:
        fail(f"{label}: contributions off by {worst} > {TOL_SHARD_CONTRIB}")
    if d_sd["surf_finite_differs"] or d_sd["surf_dist"] > TOL_SHARD_SURF:
        fail(f"{label}: surface distances off by {d_sd['surf_dist']} "
             f"({d_sd['surf_finite_differs']} finite on one side only)")
    if d["colour_share"] <= SHARD_COLOUR_SHARE:
        fail(f"{label}: colours within {TOL_SHARD_COLOUR} on only {d['colour_share']:.4f}")


def phase_sharded(device, arrays):
    """The three sharded sweeps at full width against single-device sweeps,
    the depth-slab and 2-D ones through the pipeline's --shard_axis
    dispatch; returns the depth-slab sweep's K1 launches by mode.

    The depth-slab passes 1-2 blend with the adaptive radius (no surface
    pass) and pass 3 measures over the full rect, as in the JAX package.
    The adaptive radius's rect can miss a tile a Gaussian still reaches
    with alpha >= 1/255 (the reference's getRect rounding), so the slab
    sweep is held to the single-device sweep in the same radius modes, and
    its distance from the plain surface-on sweep is printed beside it.
    surface_compact is off: the slab passes enter other chunks than one
    device would, so the surface min would cover other pairs."""
    import torch

    from gs2pc_torch import pipeline
    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess
    from gs2pc_torch.sweep import (
        init_accumulators,
        render_arrays,
        render_sweep,
        render_sweep_sharded,
    )
    from gs2pc_torch.utils.config import GaussPointCloudSettings, RenderConfig

    g = scene_on_device(arrays, device)
    cams = camera_batch(N_SHARD_CAMERAS, E2E_WIDTH, E2E_HEIGHT, device, with_masks=True)
    probe = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    longest = 0
    for i in range(cams.num_cameras):
        prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cams.at(i),
                          adaptive_radius=False)
        tiles, _ = R.order_pairs(prep, probe, circle_cull=False)
        longest = max(longest, int(R.tile_ranges(tiles, probe.num_tiles)[1].max()))
        del tiles, prep
    render = RenderConfig(max_pairs_per_tile=longest + 1, compact_pairs=True,
                          surface_compact=False)
    cfg = pipeline.tile_config(GaussPointCloudSettings(render=render),
                               cams.width_pad, cams.height_pad)
    scene = render_arrays(g)

    def dispatched(axis):
        """The sweep as the CLI's --shard_axis reaches it (surface pass on)."""
        settings = GaussPointCloudSettings(surface_distance_std=1e6, shard_axis=axis,
                                           render=render)
        return pipeline.run_render_sweep(g, cams, settings, [device] * N_SLABS)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = fn()
        torch.cuda.synchronize()
        return acc, time.perf_counter() - t0

    ref, wall_1 = timed(lambda: render_sweep(scene, cams, cfg))
    ref_adr = render_sweep(scene, cams, cfg, calc_surface_distance=False)
    sd = init_accumulators(g.num_gaussians, device=device).min_surface_distance
    for i in range(cams.num_cameras):
        cam = cams.at(i)
        ed = R.render_tile_camera(*scene, cam, cfg, calc_surface_distance=False).depth
        out = R.render_tile_camera(*scene, cam, cfg, surface_ed_override=ed.reshape(-1))
        sd = torch.minimum(sd, out.surf_dist)
    ref_sd = ref_adr._replace(min_surface_distance=sd)

    B.blend_tiles.launches = 0
    B.blend_tiles.launches_by_mode.clear()
    R.duplicate_with_keys.launches = 0
    gauss, wall_g = timed(lambda: dispatched("gauss"))
    launches = dict(B.blend_tiles.launches_by_mode)
    k2_launches = R.duplicate_with_keys.launches
    want_k1 = 3 * N_SLABS * N_SHARD_CAMERAS
    if B.blend_tiles.launches != want_k1 or any(
            launches.get(m) != N_SLABS * N_SHARD_CAMERAS for m in K1_MODES):
        fail(f"K1 launches on the depth-slab sweep: {B.blend_tiles.launches} "
             f"({launches}), expected {want_k1}: 3 per slab and camera")
    cams2, wall_c = timed(lambda: render_sweep_sharded(scene, cams, cfg, [device] * 2))
    B.blend_tiles.launches = 0
    grid, wall_2 = timed(lambda: dispatched("both"))
    # 2 x 2 grid: each camera's row splits it into 2 slabs, 3 passes each.
    if B.blend_tiles.launches != 3 * 2 * N_SHARD_CAMERAS:
        fail(f"K1 launches on the 2-D sweep: {B.blend_tiles.launches}, expected "
             f"{3 * 2 * N_SHARD_CAMERAS}")
    print(f"sharded sweeps, {N_SHARD_CAMERAS} cameras at {E2E_WIDTH}x{E2E_HEIGHT}, "
          f"{N_E2E_GAUSSIANS} Gaussians, masks, surface pass, run cap {cfg.run_cap} (longest "
          f"tile run {longest}): wall single {wall_1:.3f}s, gauss x{N_SLABS} {wall_g:.3f}s, "
          f"cams x2 {wall_c:.3f}s, 2-D 2x2 {wall_2:.3f}s; launches on the gauss sweep: K1 "
          f"{want_k1} ({launches}), K2 {k2_launches}", flush=True)
    plain = shard_diffs(gauss, ref)
    print(f"gauss sweep vs the plain surface-on single-device sweep (other radius in passes "
          f"1-2): max_contribution {plain['max_contribution']:.3g} (over "
          f"{TOL_SHARD_CONTRIB:g} on {plain['over_bound']} Gaussians), colour within "
          f"{TOL_SHARD_COLOUR:g} on {plain['colour_share']:.6f}", flush=True)
    compare_sharded(gauss, ref_adr, ref_sd,
                    f"--shard_axis gauss sweep (run_render_sweep) on [cuda:0] * {N_SLABS}")
    compare_sharded(grid, ref_adr, ref_sd,
                    f"--shard_axis both sweep (run_render_sweep) on [cuda:0] * {N_SLABS}")
    d = shard_diffs(cams2, ref)
    print(f"camera sweep on [cuda:0] * 2 vs one device: total {d['total_contribution']:.3g}; "
          f"max, colour, surface distance and counters equal: "
          f"{all(torch.equal(getattr(cams2, n), getattr(ref, n)) for n in EXACT)}", flush=True)
    for name in EXACT:
        if not torch.equal(getattr(cams2, name), getattr(ref, name)):
            fail(f"camera sweep: {name} differs from the single-device sweep")
    if d["total_contribution"] > TOL_SHARD_CONTRIB:
        fail(f"camera sweep: total contribution off by {d['total_contribution']}")
    return launches


def k3_bound():
    """(bound_ms, bound_by) of one K3 call: the (256, 128) float32 block read
    once and written once; its at most 256 x 128 adds are negligible."""
    from gs2pc_torch.ops.probe_kernels import RS, TPX

    return 1e3 * 2 * 4 * TPX * RS / HBM_BYTES_PER_S, "bytes"


def k4_bound(inputs, res):
    """(bound_ms, bound_by) of one K4 call at level 6, from this call's
    data: the chunks the tiles entered are the 128-column windows of m the
    kernel wrote.  Bytes: starts / counts / dims, the mask, table rows 0 and
    5 of the entered chunks, and every output (rgb, ed, einv, m, apix) once.
    Operations: K4_FLOPS per (pixel, lane) of an entered chunk."""
    import torch

    from gs2pc_torch.ops.probe_kernels import RS, TPX

    starts, counts, dims, table, mask = inputs
    chunks = int((~torch.isnan(res.m)).sum()) // RS
    n_out = sum(getattr(res, n).numel() for n in ("rgb", "ed", "einv", "m", "apix"))
    n_bytes = 4 * (starts.numel() + counts.numel() + dims.numel()) + mask.numel() \
        + 2 * 4 * RS * chunks + 4 * n_out
    flops = K4_FLOPS * TPX * RS * chunks
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def phase_probes(device):
    """The tools' probe path (cuda_probe, cuda_probe2, as a user runs them),
    its launches counted; then every op and level held to its twin with the
    stated bounds and timed against it."""
    import torch

    from gs2pc_torch.ops import probe_kernels as PK
    from gs2pc_torch.tools import cuda_probe, cuda_probe2
    from gs2pc_torch.tools.bench_kernels import time_probes

    dev = str(device)
    PK.probe_op.launches = 0
    PK.probe_op.launches_by_op.clear()
    PK.probe_blend.launches = 0
    runs = [cuda_probe.main(["--device", dev, "--input", kind]) for kind in ("ones", "uniform")]
    runs += [cuda_probe2.main(["--device", dev, "--input", kind]) for kind in ("ones", "seeded")]
    launches = {"probe_op": PK.probe_op.launches, "probe_blend": PK.probe_blend.launches,
                **{f"probe_op[{op}]": n for op, n in PK.probe_op.launches_by_op.items()}}
    failed = [case for r in runs for case, rec in r.items() if not rec["ok"]]
    if failed:
        fail(f"probe cases failed: {failed}")
    want = {"probe_op": 2 * len(PK.PROBE_OPS), "probe_blend": 2 * len(PK.LEVELS),
            **{f"probe_op[{op}]": 2 for _, op in PK.PROBE_OPS}}
    if launches != want:
        fail(f"probe launches {launches}, expected {want}")

    err3, err4 = 0.0, 0.0
    errs3, plain3 = {}, {}
    for kind in ("ones", "uniform"):
        x = cuda_probe.make_input(kind, device, seed=0)
        for _, op in PK.PROBE_OPS:
            got, want_t = PK.probe_op(op, x), PK.probe_op_torch(op, x)
            torch.cuda.synchronize()
            d = float((got - want_t).abs().max())
            rel = cuda_probe.rel_err(got, want_t)
            if op in PK.EXACT_OPS and d != 0.0 or rel > PROBE_RTOL:
                fail(f"K3 {op} ({kind}) differs from its twin: abs {d}, relative {rel}")
            err3 = max(err3, d)
            errs3[op] = max(errs3.get(op, 0.0), d)
            if kind == "uniform":
                plain3[op] = cuda_ms(lambda: PK.probe_op_torch(op, x), 20)
    for kind in ("ones", "seeded"):
        inputs = cuda_probe2.make_inputs(kind, device, seed=0)
        for level in PK.LEVELS:
            got, want_t = PK.probe_blend(level, *inputs), PK.probe_blend_torch(level, *inputs)
            torch.cuda.synchronize()
            rel = cuda_probe2.compare(level, got, want_t)
            if rel > PROBE_RTOL:
                fail(f"K4 level {level} ({kind}) differs from its twin by {rel} (relative)")
            err4 = max(err4, max(float((getattr(got, n) - getattr(want_t, n)).abs().max())
                                 for n in ("rgb", "ed", "einv")))
    inputs = cuda_probe2.make_inputs("seeded", device, seed=0)
    res = PK.probe_blend(6, *inputs)
    # Launch alone and through the wrapper, the floor and the library calls.
    t = time_probes(device, 200)
    ms3 = {op: v["wrapper_ms"] for op, v in t["k3"].items()}
    launch3 = {op: v["launch_ms"] for op, v in t["k3"].items()}
    dev3 = {op: v["device_ms"] for op, v in t["k3"].items()}
    k4 = dict(ms=t["k4"]["wrapper_ms"], launch_ms=t["k4"]["launch_ms"],
              device_ms=t["k4"]["device_ms"],
              plain_ms=cuda_ms(lambda: PK.probe_blend_torch(6, *inputs), 5),
              bound=k4_bound(inputs, res), max_abs_err=err4)
    k3 = dict(ms=sum(ms3.values()) / len(ms3), launch_ms=sum(launch3.values()) / len(launch3),
              plain_ms=sum(plain3.values()) / len(plain3), bound=k3_bound(), max_abs_err=err3,
              ops={op: dict(ms=ms3[op], launch_ms=launch3[op], plain_ms=plain3[op],
                            library_ms=t["library_ms"].get(op), max_abs_err=errs3[op])
                   for op in ms3})
    floor = t["floor_ms"]

    def op_line(op):
        lib = t["library_ms"].get(op)
        return (f"{op} {launch3[op]:.4f} / {dev3[op]:.4f} / {ms3[op]:.4f} ms (twin "
                f"{plain3[op]:.4f}"
                + (f", torch.{'roll' if op == 'roll' else 'cumprod'} {lib:.4f}" if lib else "")
                + ")")

    lo, hi = t["floor_range_ms"]
    print("probes, launch alone / device time (profiler) / through the wrapper: "
          + ", ".join(map(op_line, ms3))
          + f"; K3 max |err| {err3:.3g} (exact ops 0, others <= {PROBE_RTOL:g} relative), "
          f"bound {k3['bound'][0]:.2e} ms; K4 level 6 seeded {k4['launch_ms']:.4f} / "
          f"{k4['device_ms']:.4f} / {k4['ms']:.4f} ms (twin {k4['plain_ms']:.3f} ms), bound "
          f"{k4['bound'][0]:.2e} ms ({k4['bound'][1]}), max |err| {err4:.3g} (<= {PROBE_RTOL:g} "
          f"relative); floor (an empty kernel) launch alone {lo:.4f} ms before and {hi:.4f} ms "
          f"after them, device time {t['floor_device_ms']:.4f} ms, "
          f"{'above' if min(lo, hi) > max(k3['bound'][0], k4['bound'][0]) else 'not above'} both "
          f"bounds; K3 launch alone {max(launch3.values()) / floor:.2f}x the mean floor at most, "
          f"K4 {k4['launch_ms'] / floor:.2f}x; launches on the tools' path {launches}", flush=True)
    return launches, k3, k4


def phase_oracle(device):
    """validate_psnr's functions at the oracle scale: the production tile
    render against the rect-culled dense oracle (gated), and the exact
    config against the same oracle image (printed)."""
    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess
    from gs2pc_torch.tools import validate_psnr as V

    V.set_precision()
    scene = V.scene_arrays(V.capture_scene(N_ORACLE_GAUSSIANS, 0, device))
    cams = V.capture_cameras(1, E2E_WIDTH, E2E_HEIGHT, device, masks=True)
    cam = cams.at(0)
    cfg = V.tile_config(cams.width_pad, cams.height_pad, production=True)
    B.blend_tiles.launches = 0
    out_t = R.render_tile_camera(*scene, cam, cfg, calc_surface_distance=True)
    out_d, dense_s = V.oracle(scene, cam, cfg.width_pad, cfg.height_pad, rect_cull=True)
    rec = V.compare(out_t, out_d, cam)
    launched = B.blend_tiles.launches
    if launched != 1:
        fail(f"the oracle phase's tile render launched K1 {launched} times, expected 1")

    # The oracle's work: every (pixel, Gaussian) pair of the chunks up to the
    # last valid Gaussian, in blocks of 65,536 pixels and chunks of 256.
    n_valid = int(preprocess(*scene[:3], scene.alive, cam).valid.sum())
    npx = cfg.width_pad * cfg.height_pad
    blk = min(1 << 16, npx)
    evals = -(-npx // blk) * blk * -(-n_valid // 256) * 256
    prep = preprocess(*scene[:3], scene.alive, cam, adaptive_radius=False)
    tiles, _ = R.order_pairs(prep, cfg, circle_cull=False)
    longest = int(R.tile_ranges(tiles, cfg.num_tiles)[1].max())
    del tiles, prep
    exact_cfg = V.tile_config(cams.width_pad, cams.height_pad, production=False,
                              run_cap=longest + 1)
    exact = V.compare(R.render_tile_camera(*scene, cam, exact_cfg, calc_surface_distance=False),
                      out_d, cam)
    torch.cuda.synchronize()
    print(f"oracle: {N_ORACLE_GAUSSIANS} Gaussians, one {E2E_WIDTH}x{E2E_HEIGHT} camera, "
          f"mask: production tile render vs render_dense(rect_cull=True): PSNR "
          f"{rec['psnr_db']:.4f} dB (gate >= {PSNR_FLOOR_DB:g}), max |d image| "
          f"{rec['max_image_delta']:.3g}, max |d contrib| {rec['max_contrib_delta']:.3g}; "
          f"dense wall {dense_s:.3f}s ({n_valid} valid Gaussians, {evals:.4g} pair "
          f"evaluations, {evals / dense_s:.4g}/s); exact config (run cap {longest + 1}, compact off): "
          f"PSNR {exact['psnr_db']:.4f} dB, max |d image| {exact['max_image_delta']:.3g} "
          f"(not gated; DESIGN §2 expects <= 2e-4)", flush=True)
    if not rec["psnr_db"] >= PSNR_FLOOR_DB:
        fail(f"oracle PSNR {rec['psnr_db']} dB < {PSNR_FLOOR_DB} dB")
    return dict(rec, dense_s=dense_s, n_valid=n_valid, exact=exact,
                tile_image=out_t.image.cpu().numpy(), oracle_image=out_d.image.cpu().numpy())


def phase_dense_cli(device, work):
    """The CLI with --renderer_type dense --profile_dir against the tile CLI
    on the same capture."""
    import numpy as np

    from gs2pc_torch import cli
    from gs2pc_torch.utils import capture

    arrays = capture.make_scene_arrays(N_DENSE_CLI_GAUSSIANS, seed=5)
    transforms, intr = capture.make_poses(N_DENSE_CLI_CAMERAS, DENSE_CLI_WIDTH, DENSE_CLI_HEIGHT)
    ply, tj, mask_dir = capture.write_capture(work, arrays, transforms, intr, with_masks=True)
    prof = os.path.join(work, "profile")

    def argv(out):
        return ["--input_path", ply, "--transform_path", tj, "--mask_path", mask_dir,
                "--output_path", out, "--num_points", "200000", "--seed", "0", "--quiet"]

    reset_launches()
    t0 = time.perf_counter()
    dense = cli.main(argv(os.path.join(work, "dense.ply"))
                     + ["--renderer_type", "dense", "--profile_dir", prof])
    wall = time.perf_counter() - t0
    dense_launches = read_launches()
    if (dense_launches["blend_tiles"] != 0 or dense_launches["sample_points"] != cli_ranks()
            or dense_launches["preprocess"] < 1 or dense_launches["preprocess_torch"]):
        fail(f"the dense CLI launched {dense_launches}: K1 none, K5 {cli_ranks()}, K6 "
             f"without a table, never its twin, expected")
    n_dense = check_cloud(dense, os.path.join(work, "dense.ply"), "dense CLI")
    trace = os.path.join(prof, cli.TRACE_NAME)
    if not os.path.exists(trace):
        fail(f"--profile_dir wrote no {cli.TRACE_NAME}")
    with open(trace) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    phases = ("load_gaussians", "render_sweep", "cull_chain", "point_sampling")
    missing = [p for p in phases if p not in names]
    if missing:
        fail(f"the trace names no {missing}")
    cuda_events = sum(1 for n in names if n and ("kernel" in n.lower() or "cuda" in n.lower()))
    tile = cli.main(argv(os.path.join(work, "tile.ply")))
    both = (dense.cloud.counts > 0) & (tile.cloud.counts > 0)
    near = np.abs(dense.cloud.cols_u8.astype(int) - tile.cloud.cols_u8.astype(int)).max(axis=1) <= 2
    share = float(near[both].mean()) if both.any() else 0.0
    print(f"dense CLI: {N_DENSE_CLI_GAUSSIANS} Gaussians, {N_DENSE_CLI_CAMERAS} cameras at "
          f"{DENSE_CLI_WIDTH}x{DENSE_CLI_HEIGHT}, masks: {n_dense} points (quota sum "
          f"{int(dense.cloud.counts.sum())}) in {wall:.2f}s with the trace, writer "
          f"{dense.writer}; trace {os.path.getsize(trace)} bytes names {list(phases)} and "
          f"{cuda_events} kernel/CUDA event names; u8 colour within 2 of the tile CLI on "
          f"{share:.6f} of {int(both.sum())} Gaussians both sample; points tile "
          f"{tile.cloud.total}", flush=True)
    return share


def sh_coefficients(arrays, seed: int):
    """Degree-3 SH of a capture scene: f_dc carries its colours, f_rest ~
    N(0, SH_REST_STD) (channel-major, as the loader reshapes them)."""
    import numpy as np

    from gs2pc_torch.ops.sh import SH_C0

    n = arrays.xyz.shape[0]
    f_dc = ((arrays.colours - 0.5) / SH_C0).astype(np.float32)
    f_rest = np.random.default_rng(seed).normal(scale=SH_REST_STD, size=(n, 3, 15))
    return f_dc, f_rest.astype(np.float32)


def write_sh_ply(path: str, arrays, f_dc, f_rest) -> None:
    """A trained 3DGS export's layout, 59 floats a Gaussian: x y z,
    f_dc_0..2, f_rest_0..44, opacity (logit), scale_0..2, rot_0..3."""
    import numpy as np

    n = arrays.xyz.shape[0]
    op = np.clip(arrays.opacities.astype(np.float32), 1e-6, 1 - 1e-6)
    props = (["x", "y", "z"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(45)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    header = ("ply\nformat binary_little_endian 1.0\n" f"element vertex {n}\n"
              + "".join(f"property float {p}\n" for p in props) + "end_header\n")
    rows = np.concatenate([
        arrays.xyz, f_dc, f_rest.reshape(n, 45), np.log(op / (1.0 - op))[:, None],
        arrays.log_scales, arrays.rots,
    ], axis=1).astype("<f4")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(rows.tobytes())


def plane_bits_differ(got, want) -> int:
    """Elements of the float32 tensor ``got`` whose bits differ from those of
    ``want`` (a tensor or a numpy array), compared on ``got``'s device."""
    import torch

    want = torch.as_tensor(want).to(got.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel())
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def plant_decode_edges(recs) -> int:
    """Overwrite a few rows of the structured records ``recs`` (an SH
    export's) with the record decode's edge cases: zero, -0.0-w and
    negative-w quaternions, an infinite and a NaN one, NaN with payloads and
    +-inf in f_dc and the scales, colours past both clip ends; returns the
    rows planted."""
    import numpy as np

    nan = np.array([0x7FC01234, 0xFFC54321, 0x7F800001], np.uint32).view(np.float32)
    rows = [
        {"rot_0": 0, "rot_1": 0, "rot_2": 0, "rot_3": 0},
        {"rot_0": -0.0, "rot_1": 0.5, "rot_2": -0.5, "rot_3": 0.1},
        {"rot_0": -0.3, "rot_1": 0.2, "rot_2": 0.1, "rot_3": 0.9},
        {"rot_0": np.inf, "rot_1": -np.inf, "rot_2": 0, "rot_3": 0},
        {"rot_0": nan[0], "rot_1": nan[1], "rot_2": 1, "rot_3": 0},
        {"f_dc_0": nan[0], "f_dc_1": nan[2], "f_dc_2": np.inf},
        {"f_dc_0": -np.inf, "f_dc_1": 1e30, "f_dc_2": -1e30},
        {"scale_0": np.inf, "scale_1": -np.inf, "scale_2": nan[1]},
    ]
    for at, row in enumerate(rows):
        for name, value in row.items():
            recs[name][at * 997] = value
    return len(rows)


def phase_ply_decode(device, ply: str) -> dict:
    """The record decode (ops.plydecode, csrc/plydecode.cu) on the card over
    every record of the SH export ``ply``, with plant_decode_edges' rows, a
    block of CARD_BLOCK_ROWS rows at a time as the card load launches it:
    bit-equal to its twin (ply_decode_torch on the host) and to the host
    parse's _Planes.fill on the same bytes, with and without the SH plane,
    compact colours and full; one launch a block.  Then timed on one block
    (the main path's call: compact colours, no SH plane), launch alone and
    through the wrapper, beside the twin and the host fill it replaces (both
    on the host, where they run), and the bound; returns the record's numbers and the launches."""
    import numpy as np
    import torch

    from gs2pc_torch.io import gaussians_io as G
    from gs2pc_torch.io.ply import scalar_dtype
    from gs2pc_torch.ops import cuda_build, plydecode
    from gs2pc_torch.tools.bench_kernels import PLY_ENTRY, host_ms, kernel_ptxas, launch_ms

    fmt, vertex, body = G._read_header(ply)
    layout = G._card_layout(fmt, vertex, 3)
    if layout is None:
        fail("record decode: the SH export's header does not take the card path")
    n, block = vertex.count, G.CARD_BLOCK_ROWS
    recs = np.fromfile(ply, dtype=scalar_dtype(vertex, fmt), offset=body)
    planted = plant_decode_edges(recs)
    names = recs.dtype.names
    host = torch.from_numpy(recs.view(np.uint8)).pin_memory()
    records = host.to(device)
    label = (f"the SH export's {n} records of {layout.stride} B, blocks of {block} rows, "
             f"{planted} edge rows planted")
    launches, seen = 0, []
    for with_shs, compact in ((True, False), (False, True)):
        fill = G._Planes(names, n, 3, with_shs, lambda name, shape: np.empty(shape, np.float32),
                         compact)
        fill.fill(recs, 0, span=G._untimed)
        want = {"xyz": fill.xyz, "colours": fill.colours, "log_scales": fill.log_scales,
                "rots": fill.rots}
        if with_shs:
            want["shs"] = fill.shs
        twin = {k: torch.full(w.shape, float("nan")) for k, w in want.items()}
        card = {k: torch.full(w.shape, float("nan"), device=device) for k, w in want.items()}
        before = plydecode.ply_decode.launches
        for lo in range(0, n, block):
            rows = min(block, n - lo)
            cut = slice(lo * layout.stride, (lo + rows) * layout.stride)
            plydecode.ply_decode(records[cut], rows, lo, layout, card, compact)
            plydecode.ply_decode_torch(host[cut], rows, lo, layout, twin, compact)
        torch.cuda.synchronize()
        got = plydecode.ply_decode.launches - before
        launches += got
        mode = f"{'with' if with_shs else 'without'} shs, {'compact' if compact else 'full'}"
        if got != -(-n // block):
            fail(f"record decode, {mode}: {got} launches for {-(-n // block)} blocks")
        bad = {k: (plane_bits_differ(card[k], twin[k]), plane_bits_differ(card[k], want[k]))
               for k in want}
        if any(a or b for a, b in bad.values()):
            fail(f"record decode vs twin and host fill, {label}, {mode}: differing elements "
                 f"(twin, fill) {bad}")
        seen.append(f"{mode} ({got} launches)")
        del fill, want, twin, card
    print(f"record decode vs twin and host fill, {label}: every plane equal bit for bit in "
          f"{seen}", flush=True)

    rows = min(block, n)
    one = records[:rows * layout.stride]
    shapes = {"xyz": (rows, 3), "colours": (rows, 3), "log_scales": (rows, 3), "rots": (rows, 4)}
    planes = {k: torch.empty(s, dtype=torch.float32, device=device) for k, s in shapes.items()}
    twin_planes = {k: torch.empty(s, dtype=torch.float32) for k, s in shapes.items()}
    block_recs = recs[:rows]

    def call():
        plydecode.ply_decode(one, rows, 0, layout, planes, True)

    def host_fill():
        G._Planes(names, rows, 3, False, lambda name, shape: np.empty(shape, np.float32),
                  True).fill(block_recs, 0, span=G._untimed)

    before = plydecode.ply_decode.launches
    ms = dict(
        rows=rows, stride=layout.stride,
        launch_ms=launch_ms(call, [PLY_ENTRY], 20)[PLY_ENTRY],
        wrapper_ms=cuda_ms(call, 20),
        plain_ms=host_ms(lambda: plydecode.ply_decode_torch(host, rows, 0, layout, twin_planes,
                                                            True), 5),
        host_fill_ms=host_ms(host_fill, 5),
        bound=_bound(rows * (layout.stride + PLY_DECODE_WRITE_BYTES),
                     rows * PLY_DECODE_OPS),
        max_abs_err=0.0,
        ptxas=kernel_ptxas(cuda_build.BUILD_INFO.get("log", ""), "ply_decode_kernel")
        or "the library was built before this run",
    )
    torch.cuda.synchronize()
    ms["launches"] = launches + plydecode.ply_decode.launches - before
    print(f"timing, record decode, one block of {rows} records of {layout.stride} B (compact, "
          f"no SH plane): launch alone {ms['launch_ms']:.4f} ms, through the wrapper "
          f"{ms['wrapper_ms']:.4f} ms, twin on the host {ms['plain_ms']:.3f} ms, host fill "
          f"{ms['host_fill_ms']:.3f} ms, bound {ms['bound'][0]:.4f} ms ({ms['bound'][1]}), "
          f"{ms['bound'][0] / ms['launch_ms']:.1%} of the bound; ptxas: {ms['ptxas']}",
          flush=True)
    return ms


def files_equal(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def phase_sh(device, work, arrays, plain_cols, tj, mask_dir):
    """The CLI with --sh_colour_eval --save_sweep on the e2e scene as an SH
    export, then the saved sweep resumed without transforms."""
    import torch

    from gs2pc_torch import cli, pipeline
    from gs2pc_torch.io.ply import save_point_cloud_ply
    from gs2pc_torch.utils import log
    from gs2pc_torch.utils.checkpoint import load_accumulators
    from gs2pc_torch.utils.config import parse_args, settings_from_args

    t0 = time.perf_counter()
    ply = os.path.join(work, "scene_sh.ply")
    write_sh_ply(ply, arrays, *sh_coefficients(arrays, seed=6))
    print(f"SH capture written in {time.perf_counter() - t0:.1f}s ({os.path.getsize(ply)} bytes, "
          f"{N_E2E_GAUSSIANS} Gaussians of degree 3)", flush=True)
    out, sweep = os.path.join(work, "cloud_sh.ply"), os.path.join(work, "sweep.npz")
    argv = e2e_argv(ply, tj, mask_dir, out) + [
        "--surface_distance_std", "1e6", "--sh_colour_eval", "--save_sweep", sweep]
    saved, loaded_scene = [], []
    real_save, real_load = pipeline.save_accumulators, pipeline.load_gaussians

    def keep_saved(path, acc, *a, **kw):
        saved.append(acc)
        return real_save(path, acc, *a, **kw)

    def keep_loaded(path, **kw):
        scene = real_load(path, **kw)
        loaded_scene.append((scene, kw))
        return scene

    log.reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(pipeline, "save_accumulators", keep_saved), \
            mock.patch.object(pipeline, "load_gaussians", keep_loaded):
        result = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    hold_card_load(ply, *loaded_scene[0])
    del loaded_scene
    want = conversion_launches(N_E2E_CAMERAS, 1, decoded=N_E2E_GAUSSIANS)
    if launches != want:
        fail(f"SH conversion: kernel launches {launches}, expected {want}")
    n_file = check_cloud(result, out, "SH conversion")
    if abs(n_file - N_POINTS) > 0.01 * N_POINTS:
        fail(f"SH conversion: {n_file} points written for a budget of {N_POINTS}")
    zmax = mahalanobis_max(result.cloud, arrays)
    if zmax > 2.0 + 1e-3:
        fail(f"SH conversion: a sampled point lies {zmax} deviations from its Gaussian")
    moved = int((result.cloud.cols_u8 != plain_cols).any(axis=1).sum())
    if moved == 0:
        fail("SH conversion: the colours equal the degree-0 conversion's everywhere")
    phases = {k: round(v, 3) for k, v in log.PHASE_SECONDS.items()}
    print(f"SH conversion (--sh_colour_eval, {N_E2E_CAMERAS} cameras at {E2E_WIDTH}x"
          f"{E2E_HEIGHT}, masks): {n_file} points in {wall:.2f}s; scene_parse "
          f"{phases['scene_parse']:.3f}s, scene_upload {phases['scene_upload']:.3f}s, "
          f"render_sweep {phases['render_sweep']:.3f}s, save_sweep {phases['save_sweep']:.3f}s; "
          f"launches {launches}; u8 colour other than the degree-0 conversion's on {moved} of "
          f"{len(plain_cols)} Gaussians; counters {result.sweep_diag}; max sampled |z| "
          f"{zmax:.4f}; phases {json.dumps(phases)}", flush=True)

    # Resume: the saved sweep, no transforms, no masks.
    if len(saved) != 1:
        fail(f"--save_sweep saved {len(saved)} sweeps")
    loaded = load_accumulators(sweep, N_E2E_GAUSSIANS, scene_xyz=arrays.xyz, device=device)
    for name in ("max_contribution", "colours", "total_contribution", "min_surface_distance"):
        if not torch.equal(getattr(loaded, name), getattr(saved[0], name)):
            fail(f"the loaded sweep's {name} differs from the saved one")
    settings = settings_from_args(parse_args(argv))._replace(save_sweep=None, load_sweep=sweep)
    out2 = os.path.join(work, "cloud_resumed.ply")
    log.reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    res2 = pipeline.convert_3dgs_to_pc(ply, None, None, settings, device=device)
    writer = save_point_cloud_ply(res2.cloud, out2)
    wall2 = time.perf_counter() - t0
    resumed = read_launches()
    if (resumed != conversion_launches(0, 1, sweeps=False, decoded=N_E2E_GAUSSIANS)
            or res2.sweep_diag is not None):
        fail(f"the resumed conversion rendered or did not sample on one card: {resumed}")
    same = files_equal(out, out2)
    print(f"resume (--load_sweep, no transforms): accumulators equal the saved ones bit for "
          f"bit; {res2.cloud.total} points in {wall2:.2f}s ({writer} writer), load_sweep "
          f"{log.PHASE_SECONDS['load_sweep']:.3f}s ({os.path.getsize(sweep)} bytes); PLY equal "
          f"to the first byte for byte: {same}", flush=True)
    if not same:
        fail("the resumed conversion wrote another PLY")
    for path in (out, out2, sweep):
        os.remove(path)
    decode = phase_ply_decode(device, ply)
    os.remove(ply)
    decode["launches"] += launches["ply_decode"] + resumed["ply_decode"]
    return dict(wall=wall, phases=phases, launches=launches, decode=decode)


def hold_card_load(ply: str, scene, kw: dict) -> None:
    """The planes load_gaussians decoded on the card (``scene``, loaded
    with ``kw``) against load_ply_gaussians' host parse of ``ply`` with the
    same options, bit for bit."""
    from gs2pc_torch.io.gaussians_io import load_ply_gaussians

    want = load_ply_gaussians(ply, max_sh_degree=kw["max_sh_degree"], with_shs=kw["with_shs"],
                              compact_colours=kw["compact_colours"])
    names = ("xyz", "log_scales", "rots", "colours", "opacities", "shs")
    bad = {}
    for name, w in zip(names, want):
        got = getattr(scene, name)
        if (got is None) != (w is None):
            fail(f"SH conversion's load: {name} is {got} on the card, the host parse's {w}")
        if got is not None:
            bad[name] = plane_bits_differ(got, w)
    if any(bad.values()):
        fail(f"SH conversion's load: planes decoded on the card differ from the host parse's "
             f"bit for bit, elements {bad}")
    held = (f"{scene.num_gaussians} Gaussians, planes {sorted(bad)} equal to the host parse's "
            f"bit for bit ({', '.join(f'{k}={v}' for k, v in sorted(kw.items()) if k != 'device')})")
    print(f"SH conversion's load on the card: {held}", flush=True)


def phase_k1_sh(device):
    """K1 against its twin, bit for bit, on a table whose colours are one
    camera's view of the scene's SH."""
    import dataclasses

    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops.rasterize import TileConfig
    from gs2pc_torch.ops.sh import view_colours
    from gs2pc_torch.utils import capture

    arrays = capture.make_scene_arrays(N_SH_K1_GAUSSIANS, seed=2)
    f_dc, f_rest = sh_coefficients(arrays, seed=7)
    coeffs = torch.cat([torch.tensor(f_dc)[:, :, None], torch.tensor(f_rest)], dim=2).to(device)
    g = scene_on_device(arrays, device)
    cams = camera_batch(1, 256, 192, device, with_masks=True)
    cam = cams.at(0)
    g = dataclasses.replace(g, colours=view_colours(3, coeffs, g.xyz, cam.campos))
    cfg = TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad, compact=True,
                     surface_compact=True)
    _, args, kw = blend_inputs(g, cam, cfg)
    k = B.blend_tiles(*args, **kw)
    t = B.blend_tiles_torch(*args, **kw)
    torch.cuda.synchronize()
    err = compare_k1(k, t, f"{N_SH_K1_GAUSSIANS} Gaussians 256x192, the SH colours of camera 0")
    if err != 0.0 or not torch.equal(k.best_pix, t.best_pix):
        fail(f"K1 on the SH table is not bit-equal to its twin (max |err| {err})")


def phase_mesh(device, work, ply, tj, mask_dir):
    """BASELINE config 5 at full width: --clean_pointcloud --generate_mesh
    with the default depth and smoothing."""
    import numpy as np
    import torch

    from gs2pc_torch import cli, meshing
    from gs2pc_torch.io.ply import read_ply
    from gs2pc_torch.utils import log

    out, mesh_out = os.path.join(work, "cloud_mesh.ply"), os.path.join(work, "mesh.ply")
    totals = []
    real_clean = cli.clean_point_cloud

    def count_clean(cloud, **kw):
        totals.append(cloud.total)
        return real_clean(cloud, **kw)

    log.reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(cli, "clean_point_cloud", count_clean):
        result = cli.main(e2e_argv(ply, tj, mask_dir, out) + [
            "--clean_pointcloud", "--generate_mesh", "--mesh_output_path", mesh_out])
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = conversion_launches(N_E2E_CAMERAS, 2)
    if launches != want:
        fail(f"mesh conversion: kernel launches {launches}, expected {want}")
    n_file = check_cloud(result, out, "mesh conversion (cleaned cloud)")
    n_surface, n_mesh = result.surface_quota
    want_mesh = min(N_POINTS // 2, n_surface * 25)
    if n_mesh != want_mesh or n_surface == 0:
        fail(f"surface quota {n_mesh} for {n_surface} surface Gaussians, expected {want_mesh}")
    mesh = result.mesh
    if mesh.mesher != "native":
        fail(f"the mesh came from the {mesh.mesher} mesher, not the native one")
    if len(mesh.faces) == 0 or not np.isfinite(mesh.verts).all():
        fail(f"empty or non-finite mesh: {len(mesh.verts)} vertices, {len(mesh.faces)} faces")
    elements = read_ply(mesh_out)
    if (elements["vertex"].count, elements["face"].count) != (len(mesh.verts), len(mesh.faces)):
        fail("the mesh PLY holds other counts than the mesh")
    phases = {k: round(log.PHASE_SECONDS.get(k, 0.0), 3) for k in MESH_PHASES}
    print(f"mesh conversion (BASELINE config 5: --clean_pointcloud --generate_mesh, depth 10 -> "
          f"grid 384, 10 smoothing rounds; {N_E2E_CAMERAS} cameras, {N_POINTS} points) in "
          f"{wall:.2f}s: cleaning kept {n_file} of {totals[0]} points; surface quota {n_mesh} "
          f"points for {n_surface} surface Gaussians (min(N // 2, 25 x count)); surface cloud "
          f"{result.surface_cloud.total} points, {mesh.points} after outlier removal; mesh "
          f"{len(mesh.verts)} vertices, {len(mesh.faces)} faces ({mesh.mesher} mesher); launches "
          f"{launches}; render_sweep {log.PHASE_SECONDS['render_sweep']:.3f}s; steps "
          f"{json.dumps(phases)}", flush=True)

    # The outlier mask on the card against the CPU, on 200k surface points.
    surf = result.surface_cloud.points
    pts = surf[np.random.default_rng(0).choice(len(surf), size=min(N_OUTLIER_CHECK, len(surf)),
                                                replace=False)]
    on_card = meshing.statistical_outlier_mask(torch.tensor(pts, device=device), std_ratio=3.0)
    on_cpu = meshing.statistical_outlier_mask(torch.tensor(pts), std_ratio=3.0)
    d = meshing.knn_mean_distance(torch.tensor(pts)).double()
    thr = d.mean() + 3.0 * d.std(correction=0)
    near = (d - thr).abs() <= OUTLIER_NEAR_RTOL * thr
    off = int((on_card.cpu() != on_cpu)[~near].sum())
    print(f"outlier mask, {len(pts)} surface points, std_ratio 3: card vs CPU differ on {off} "
          f"points away from the threshold; {int(near.sum())} within {OUTLIER_NEAR_RTOL:g} "
          f"relative of it; {int((~on_cpu).sum())} outliers", flush=True)
    if off:
        fail(f"the outlier mask on the card differs from the CPU's on {off} points")
    for path in (out, mesh_out):
        os.remove(path)
    return dict(wall=wall, phases=phases, launches=launches)


def phase_auto_capacity(device, work, ply, tj, mask_dir):
    """--auto_capacity on the first cameras of the capture at a run cap
    their tiles overflow: the sweep re-renders with the cap doubled."""
    from gs2pc_torch import cli
    from gs2pc_torch.pipeline import AUTO_CAPACITY_ATTEMPTS, truncation_material

    with open(tj) as fh:
        frames = json.load(fh)["frames"][:N_AUTO_CAMERAS]
    n_cams = len(frames)
    tj4 = os.path.join(work, "transforms_4.json")
    with open(tj4, "w") as fh:
        json.dump({"frames": frames}, fh)
    out = os.path.join(work, "cloud_auto.ply")
    reset_launches()
    t0 = time.perf_counter()
    result = cli.main(e2e_argv(ply, tj4, mask_dir, out, N_AUTO_POINTS) + [
        "--surface_distance_std", "1e6", "--max_pairs_per_tile", str(AUTO_RUN_CAP),
        "--auto_capacity"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches["project_and_pack"] != launches["blend_tiles"] or launches["preprocess_torch"]:
        fail(f"--auto_capacity: launches {launches}: one K6 a K1, never its twin, expected")
    attempts, rest = divmod(launches["blend_tiles"], n_cams)
    _, material = truncation_material(result.sweep_diag)
    pairs, _, cap_drop, cap_live = result.sweep_diag[:4]
    final_cap = AUTO_RUN_CAP << (attempts - 1)
    print(f"--auto_capacity, {n_cams} cameras, --max_pairs_per_tile {AUTO_RUN_CAP}: "
          f"{attempts} sweeps (K1 launches {launches['blend_tiles']} = {n_cams} cameras x "
          f"{attempts}), final run cap {final_cap}; final sweep {pairs:,.0f} pairs blended, "
          f"{cap_drop:,.0f} beyond the cap, {cap_live:,.0f} on live tiles "
          f"({100.0 * cap_live / max(pairs, 1.0):.3f}%, material: {material}); "
          f"{result.cloud.total} points in {wall:.2f}s", flush=True)
    if rest or not 2 <= attempts <= AUTO_CAPACITY_ATTEMPTS:
        fail(f"--auto_capacity ran {launches['blend_tiles']} K1 launches on {n_cams} "
             "cameras: expected 2 or 3 sweeps")
    if launches["sample_points"] != cli_ranks():
        fail(f"--auto_capacity: K5 launched {launches['sample_points']} times, expected "
             f"{cli_ranks()}")
    if material and attempts < AUTO_CAPACITY_ATTEMPTS:
        fail("--auto_capacity stopped while the drops were still material")
    check_cloud(result, out, "--auto_capacity conversion")
    os.remove(out)
    return dict(attempts=attempts, final_cap=final_cap, launches=launches)


def phase_covariances(device):
    """Gaussians.from_covariances on the card against the CPU: 1M seeded
    covariances at 3DGS scales, every other one not PSD."""
    import numpy as np
    import torch

    from gs2pc_torch.models.gaussians import Gaussians
    from gs2pc_torch.ops.linalg3 import bmm33_nt
    from gs2pc_torch.ops.quaternion import quat_to_rotmat

    n = N_COVARIANCES
    r = np.random.default_rng(12)
    q = r.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = quat_to_rotmat(torch.tensor(q)).numpy()
    lam = np.sort(np.exp(2.0 * r.uniform(-5.0, -2.0, (n, 3))), axis=1)
    lam[::2, 0] = -r.uniform(1e-6, 1e-3, n // 2)
    sigma = np.einsum("nij,nj,nkj->nik", rot, lam, rot).astype(np.float32)
    xyz = r.normal(size=(n, 3)).astype(np.float32)
    cols, opac = r.uniform(size=(n, 3)).astype(np.float32), r.uniform(size=n).astype(np.float32)
    out, secs = [], []
    for dev in ("cpu", device):
        t0 = time.perf_counter()
        g = Gaussians.from_covariances(xyz, sigma, cols, opac, device=dev)
        M = g.covariance_factors()
        cov, keep = bmm33_nt(M, M).cpu(), g.keep_mask.cpu()
        secs.append(time.perf_counter() - t0)
        out.append((cov, keep))
    scale = out[0][0].abs().amax(dim=(1, 2), keepdim=True)
    rel = float(((out[1][0] - out[0][0]).abs() / scale).max())
    differ = int((out[1][1] != out[0][1]).sum())
    print(f"from_covariances: {n} covariances ({n // 2} not PSD), card {secs[1]:.3f}s vs CPU "
          f"{secs[0]:.3f}s: Sigma within {rel:.3g} relative of the largest entry (<= "
          f"{COV_RTOL:g}); kept {int(out[1][1].sum())} on the card, {int(out[0][1].sum())} on "
          f"the CPU; keep masks differ on {differ} rows", flush=True)
    if not rel <= COV_RTOL:
        fail(f"from_covariances: Sigma on the card off by {rel} relative")
    if differ:
        fail(f"from_covariances: keep masks differ on {differ} rows")


def launched() -> dict:
    """K1, K2, key sort, K5 and K6 launches since reset_launches() (K6 with
    its table; "K6 alone" without), and the calls of K6's twin."""
    got = read_launches()
    return {"K1": got["blend_tiles"], "K2": got["duplicate_with_keys"],
            "sorts": got["order_pairs"],
            "K5": got["sample_points"], "K6": got["project_and_pack"],
            "K6 alone": got["preprocess"], "twin": got["preprocess_torch"]}


def phase_preview(device, work, ply, tj):
    """render_preview --depth on the e2e capture, 4 cameras at full width:
    each decoded PNG equals the 8-bit quantisation of render_camera's image
    (and of its min-max normalised depth)."""
    import torch

    from gs2pc_torch.sweep import render_camera
    from gs2pc_torch.tools import render_preview
    from gs2pc_torch.utils.imaging import imread_png, to_u8

    out_dir = os.path.join(work, "previews")
    reset_launches()
    t0 = time.perf_counter()
    written = render_preview.main([
        "--input_path", ply, "--transform_path", tj, "--out_dir", out_dir,
        "--max_images", str(N_PREVIEW_CAMERAS), "--colour_quality", "original", "--depth",
        "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = launched()
    want = {"K1": N_PREVIEW_CAMERAS, "K2": 2 * N_PREVIEW_CAMERAS,
            "sorts": 2 * N_PREVIEW_CAMERAS, "K5": 0,
            "K6": N_PREVIEW_CAMERAS, "K6 alone": 0, "twin": 0}
    if launches != want or len(written) != 2 * N_PREVIEW_CAMERAS:
        fail(f"preview: launches {launches} (expected {want}), {len(written)} files written")
    scene = render_preview.scene_arrays(render_preview.load_gaussians(ply, device=device))
    transforms, intr = render_preview.load_transform_data(tj)
    names = list(transforms)[:N_PREVIEW_CAMERAS]
    cams = render_preview.build_camera_batch({k: transforms[k] for k in names}, intr,
                                             device=device)
    cfg = render_preview.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    for i, name in enumerate(names):
        cam = cams.at(i)
        o = render_camera(scene, cam, cfg, calc_surface_distance=False)
        h, w = cam.height, cam.width
        want_img = to_u8(o.image[:h, :w].cpu().numpy())
        want_depth = to_u8(render_preview.normalised_depth(o.depth[:h, :w].cpu().numpy()))
        got_img = imread_png(os.path.join(out_dir, f"{name}.png"))
        got_depth = imread_png(os.path.join(out_dir, f"{name}_depth.png"))
        if not (got_img.shape == (h, w, 3) and (got_img == want_img).all()
                and (got_depth == want_depth).all()):
            fail(f"preview: {name}'s PNGs differ from render_camera's image / depth")
    del scene
    torch.cuda.synchronize()
    print(f"preview: render_preview --depth, {N_PREVIEW_CAMERAS} cameras at "
          f"{cams.width_pad}x{cams.height_pad} padded, {N_E2E_GAUSSIANS} Gaussians, in "
          f"{wall:.3f}s (scene load included); launches {launches}; every PNG equal to "
          f"render_camera's image and depth, 8-bit", flush=True)
    return dict(wall=wall, launches=launches)


def phase_convert(work, ply):
    """convert_format .ply -> .splat -> .ply on the 3M-Gaussian capture."""
    import numpy as np

    from gs2pc_torch.tools import convert_format

    splat, back = os.path.join(work, "scene.splat"), os.path.join(work, "back.ply")
    t0 = time.perf_counter()
    n1 = convert_format.main([ply, splat])
    t1 = time.perf_counter()
    n2 = convert_format.main([splat, back])
    t2 = time.perf_counter()
    a, b = convert_format.load_host(ply), convert_format.load_host(back)
    errs = dict(xyz=float(np.abs(a[0] - b[0]).max()),
                opacity=float(np.abs(a[4] - b[4]).max()),
                log_scale=float(np.abs(a[1] - b[1]).max()))
    print(f"convert: {n1} Gaussians .ply -> .splat {t1 - t0:.3f}s "
          f"({os.path.getsize(splat)} bytes), .splat -> .ply {t2 - t1:.3f}s; round trip max "
          f"|d| xyz {errs['xyz']:.3g} (<= {TOL_CONVERT_XYZ:g}), opacity {errs['opacity']:.3g} "
          f"(<= {TOL_CONVERT_OPACITY:.3g}), log scale {errs['log_scale']:.3g} "
          f"(<= {TOL_CONVERT_LOG_SCALE:g})", flush=True)
    if n1 != N_E2E_GAUSSIANS or n2 != n1:
        fail(f"convert: {n1} then {n2} Gaussians, expected {N_E2E_GAUSSIANS}")
    if not (errs["xyz"] <= TOL_CONVERT_XYZ and errs["opacity"] <= TOL_CONVERT_OPACITY
            and errs["log_scale"] <= TOL_CONVERT_LOG_SCALE):
        fail(f"convert: the round trip is off: {errs}")
    os.remove(splat)
    os.remove(back)
    return dict(to_splat_s=t1 - t0, to_ply_s=t2 - t1)


def phase_splits(device, arrays):
    """The e2e scene's 16 cameras at full width: the camera split on
    [cuda:0] * 2, the depth-slab and 2-D sweeps on [cuda:0] * 4 (and all
    three on every card where there are several), each run twice: the same
    bits both times, and held to one device (the camera split exactly but
    for the total's summation order, the slab sweeps as in phase 9).  Walls
    beside the one-device sweep's, timed before and after them."""
    import torch

    from gs2pc_torch import pipeline
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess
    from gs2pc_torch.parallel.gauss_shard import (
        grid_2d,
        render_sweep_2d,
        render_sweep_gauss_sharded,
    )
    from gs2pc_torch.sweep import (
        init_accumulators,
        render_arrays,
        render_sweep,
        render_sweep_sharded,
    )
    from gs2pc_torch.utils.config import GaussPointCloudSettings, RenderConfig

    g = scene_on_device(arrays, device)
    cams = camera_batch(N_E2E_CAMERAS, E2E_WIDTH, E2E_HEIGHT, device, with_masks=True)
    probe = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    longest = 0
    for i in range(cams.num_cameras):
        prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cams.at(i),
                          adaptive_radius=False)
        tiles, _ = R.order_pairs(prep, probe, circle_cull=False)
        longest = max(longest, int(R.tile_ranges(tiles, probe.num_tiles)[1].max()))
        del tiles, prep
    render = RenderConfig(max_pairs_per_tile=longest + 1, compact_pairs=True,
                          surface_compact=False)
    cfg = pipeline.tile_config(GaussPointCloudSettings(render=render),
                               cams.width_pad, cams.height_pad)
    scene = render_arrays(g)

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        acc = fn(*args, **kw)
        torch.cuda.synchronize()
        return acc, time.perf_counter() - t0, launched()

    one, one_first, _ = timed(render_sweep, scene, cams, cfg)
    ref_adr = render_sweep(scene, cams, cfg, calc_surface_distance=False)
    sd = init_accumulators(g.num_gaussians, device=device).min_surface_distance
    for i in range(cams.num_cameras):
        cam = cams.at(i)
        ed = R.render_tile_camera(*scene, cam, cfg, calc_surface_distance=False).depth
        sd = torch.minimum(sd, R.render_tile_camera(*scene, cam, cfg,
                                                    surface_ed_override=ed.reshape(-1)).surf_dist)
    ref_sd = ref_adr._replace(min_surface_distance=sd)

    want_k1 = {"cameras": N_E2E_CAMERAS, f"gauss x{N_SPLIT_SLABS}":
               3 * N_SPLIT_SLABS * N_E2E_CAMERAS, "2-D 2x2": 3 * 2 * N_E2E_CAMERAS}
    splits = [("cameras", render_sweep_sharded, [device] * 2),
              (f"gauss x{N_SPLIT_SLABS}", render_sweep_gauss_sharded, [device] * N_SPLIT_SLABS),
              ("2-D 2x2", render_sweep_2d, [device] * N_SPLIT_SLABS)]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        from gs2pc_torch.parallel import mesh

        cards = mesh.devices(n_cards)
        splits += [(f"cameras on {n_cards} cards", render_sweep_sharded, cards),
                   (f"gauss on {n_cards} cards", render_sweep_gauss_sharded, cards),
                   (f"2-D on {n_cards} cards", render_sweep_2d, cards)]
        rows = len(grid_2d(cards))
        want_k1 = dict(want_k1, **{f"cameras on {n_cards} cards": N_E2E_CAMERAS,
                                   f"gauss on {n_cards} cards": 3 * n_cards * N_E2E_CAMERAS,
                                   f"2-D on {n_cards} cards":
                                   3 * (n_cards // rows) * N_E2E_CAMERAS})
    out, walks = {}, {}
    for label, sweep, devices in splits:
        runs = [timed(sweep, scene, cams, cfg, devices) for _ in range(2)]
        for acc, _, launches in runs:
            if (launches["K1"] != want_k1[label] or launches["K2"] < 1
                    or launches["K6"] != launches["K1"] or launches["twin"]):
                fail(f"splits, {label}: launches {launches}, expected K1 and K6 "
                     f"{want_k1[label]}, never K6's twin")
        acc = runs[0][0]
        if not same_bits(acc, runs[1][0]):
            fail(f"splits, {label}: the accumulators differ between two runs")
        hold_split(f"splits, {label}", acc, one, ref_adr, ref_sd)
        out[label] = [w for _, w, _ in runs]
        walks[label] = acc
        print(f"splits, {label}: {N_E2E_CAMERAS} cameras at {E2E_WIDTH}x{E2E_HEIGHT}, run cap "
              f"{cfg.run_cap}: walls {runs[0][1]:.4f} / {runs[1][1]:.4f}s; the same bits both "
              f"times, held to one device; launches {runs[0][2]}", flush=True)
    _, one_last, _ = timed(render_sweep, scene, cams, cfg)
    out["one device"] = [one_first, one_last]
    print(f"splits: the one-device sweep of the same cameras {one_first:.4f} / {one_last:.4f}s "
          f"(before / after the splits)", flush=True)
    return dict(walls=out, walks=walks, scene=scene, cams=cams, cfg=cfg, one=one,
                ref_adr=ref_adr, ref_sd=ref_sd)


def spmd_bringup() -> dict:
    """The spawned ranks' bring-up and sweep phases, the slowest rank's
    (launch files them as rank<r>/<phase>), with rank 0's group formation."""
    from gs2pc_torch.utils import log

    out = {"rank0 spmd_group_init": log.PHASE_SECONDS.get("spmd_group_init", 0.0)}
    for key, seconds in log.PHASE_SECONDS.items():
        if key.startswith("rank"):
            name = key.split("/", 1)[1]
            out[name] = round(max(out.get(name, 0.0), seconds), 4)
    return out


def phase_spmd(device, splits, e2e, work):
    """The SPMD sweeps (one process per rank, gs2pc_torch.parallel.launch)
    of phase 20's 16 cameras at full width: the camera split on
    [cuda:0] * 2 and the depth-slab and 2-D sweeps on [cuda:0] * 4 through
    gloo, and all three over every card through NCCL where there are
    several; each bit-equal to phase 20's walk on the same devices and held
    to one device as phase 20 holds the walks, every rank's K1 launches as
    its share asks.  Walls (rank 0, the card synchronised) beside the
    walks', and the spawned ranks' bring-up.  On several cards also the CLI
    at --num_devices 0 (cameras) and --shard_axis gauss, each PLY byte-equal
    to the walk's conversion, and a rank that raises over NCCL."""
    import multiprocessing

    import torch

    from gs2pc_torch import pipeline
    from gs2pc_torch.parallel import dryrun, launch, mesh
    from gs2pc_torch.parallel.mesh import split_evenly
    from gs2pc_torch.utils import log
    from gs2pc_torch.utils.config import parse_args, settings_from_args

    n_cards = torch.cuda.device_count()
    conv_argv = e2e_argv(e2e["ply"], e2e["tj"], e2e["masks"], os.path.join(work, "unused.ply")) \
        + ["--surface_distance_std", "1e6", "--generate_mesh"]
    conversion = (pipeline.convert_rank,
                  (e2e["ply"], e2e["tj"], e2e["masks"], settings_from_args(parse_args(conv_argv))))
    cams_k1 = [hi - lo for lo, hi in split_evenly(N_E2E_CAMERAS, 2)]
    rows = [hi - lo for lo, hi in split_evenly(N_E2E_CAMERAS, 2)]
    groups = [([device] * 2, [("cams", "cameras", cams_k1)]),
              ([device] * N_SPLIT_SLABS,
               [("gauss", f"gauss x{N_SPLIT_SLABS}", [3 * N_E2E_CAMERAS] * N_SPLIT_SLABS),
                ("both", "2-D 2x2", [3 * rows[r // 2] for r in range(4)])])]
    if n_cards > 1:
        from gs2pc_torch.parallel.gauss_shard import grid_2d

        cards = mesh.devices(n_cards)
        grid = grid_2d(cards)
        g = len(grid[0])
        blocks = [hi - lo for lo, hi in split_evenly(N_E2E_CAMERAS, len(grid))]
        groups.append((cards, [
            ("cams", f"cameras on {n_cards} cards",
             [hi - lo for lo, hi in split_evenly(N_E2E_CAMERAS, n_cards)]),
            ("gauss", f"gauss on {n_cards} cards", [3 * N_E2E_CAMERAS] * n_cards),
            ("both", f"2-D on {n_cards} cards", [3 * blocks[r // g] for r in range(n_cards)]),
        ]))
    out = {}
    log.set_quiet(True)
    for devices, jobs in groups:
        root = (splits["scene"], splits["cams"], None)
        log.reset_phases()
        reset_launches()
        starts = launch.RANK_STARTS
        t0 = time.perf_counter()
        res = launch.run(launch.in_turn, devices,
                         [(dryrun.sweep_rank, (split, splits["cfg"])) for split, _, _ in jobs]
                         + [conversion], root=[root] * len(jobs) + [None])
        wall = time.perf_counter() - t0
        k5_by_rank = [r[2] for r in launches_by_rank()]
        bringup = spmd_bringup()
        # Each group's devices differ from the pool before it: a new pool.
        if (launch.RANK_STARTS - starts != len(devices) - 1
                or "spmd_spawn_import" not in bringup):
            fail(f"spmd, {len(devices)} ranks: {launch.RANK_STARTS - starts} ranks started, "
                 f"bring-up {bringup}; expected a new pool of {len(devices) - 1}")
        backend = "nccl" if len(set(devices)) > 1 else "gloo"
        spmd_sampler(res.pop(), devices, conversion[1], k5_by_rank, work, backend)
        for (split, label, want_k1), (acc, sweep_wall, launches) in zip(jobs, res):
            if not same_bits(acc, splits["walks"][label]):
                fail(f"spmd, {label}: the SPMD sweep differs from the walk")
            hold_split(f"spmd, {label}", acc, splits["one"], splits["ref_adr"],
                       splits["ref_sd"])
            if [k1 for k1, _ in launches] != want_k1 or min(k2 for _, k2 in launches) < 1:
                fail(f"spmd, {label}: launches per rank {launches}, expected K1 {want_k1}")
            out[label] = sweep_wall
            print(f"spmd, {label}: {len(devices)} ranks over {backend}, {N_E2E_CAMERAS} cameras "
                  f"at {E2E_WIDTH}x{E2E_HEIGHT}: sweep wall {sweep_wall:.4f}s (the walk "
                  f"{splits['walls'][label][0]:.4f} / {splits['walls'][label][1]:.4f}s); "
                  f"bit-equal to the walk, held to one device; [K1, K2] per rank {launches}",
                  flush=True)
        print(f"spmd: {len(devices)} ranks, {len(jobs)} sweep(s) in {wall:.3f}s with the spawn; "
              f"bring-up {json.dumps(bringup)}", flush=True)
    if n_cards > 1:
        out.update(spmd_cli(device, e2e, work, n_cards))
        t0 = time.perf_counter()
        try:
            launch.run(dryrun.fail_on_rank, cards, n_cards - 1, timeout=120)
        except dryrun.PlantedFailure as exc:
            wall = time.perf_counter() - t0
            launch.shutdown()
            left = multiprocessing.active_children()
            if left:
                fail(f"spmd: ranks left running after a failed rank: {left}")
            print(f"spmd: a rank that raises over NCCL fails the run in {wall:.2f}s: {exc}",
                  flush=True)
        else:
            fail("spmd: a planted failure on the last card did not fail the run")
    return out


def spmd_sampler(res, devices, conv_args, k5_by_rank, work, backend) -> None:
    """Hold an SPMD conversion's split samplings (the cloud and the
    --generate_mesh surface cloud; each rank sampled a block of each with
    K5) to the walk on the same devices, which samples on one card: both
    PLYs byte-equal, and every rank's K5 launched once a sampling."""
    from gs2pc_torch import pipeline
    from gs2pc_torch.io.ply import save_point_cloud_ply
    from gs2pc_torch.utils import log

    label = f"spmd sampler, {len(devices)} ranks over {backend}"
    if k5_by_rank != [2] * len(devices):
        fail(f"{label}: K5 launches per rank {k5_by_rank}, expected 2 on each")
    names = ("point_sampling", "surface_sampling")
    split_s = [round(log.PHASE_SECONDS[k], 4) for k in names]
    walk = pipeline._convert_walked(*conv_args, device=devices[0], devices=devices)
    one_s = [round(log.PHASE_SECONDS[k], 4) for k in names]
    sizes = []
    for name in ("cloud", "surface_cloud"):
        a, b = getattr(res, name), getattr(walk, name)
        pa, pb = os.path.join(work, "spmd_split.ply"), os.path.join(work, "walk_split.ply")
        save_point_cloud_ply(a, pa, chunk_size=10**6)
        save_point_cloud_ply(b, pb, chunk_size=10**6)
        if not files_equal(pa, pb):
            fail(f"{label}: the {name}'s PLY differs from the walk's (one card samples)")
        sizes.append(a.total)
        os.remove(pa)
        os.remove(pb)
    print(f"{label}: the e2e conversion with --generate_mesh, {sizes[0]} + {sizes[1]} points "
          f"sampled in {len(devices)} blocks; both PLYs byte-equal to the walk's, which samples "
          f"on one card; K5 per rank {k5_by_rank}; [point_sampling, surface_sampling] split "
          f"{split_s} s, on one card {one_s} s", flush=True)


def spmd_cli(device, e2e, work, n_cards: int) -> dict:
    """The e2e CLI on every card: at --num_devices 0 (the camera split) and
    at --shard_axis gauss, one process per card over NCCL, both over the
    pool of ranks phase_spmd's last group left (no rank started, no
    bring-up phase filed); each PLY byte-equal to the walk's conversion
    written by the same writer, K1 and K2 launched as often over all the
    ranks as the split asks in each run alone (16 and 32 on the cameras,
    3 x cards times that on the slabs); walls."""
    from gs2pc_torch import cli, pipeline
    from gs2pc_torch.io.ply import save_point_cloud_ply
    from gs2pc_torch.parallel import launch
    from gs2pc_torch.utils import log
    from gs2pc_torch.utils.config import parse_args, settings_from_args

    out = {}
    for extra, label, want_k1 in (
            (["--num_devices", "0"], "--num_devices 0", N_E2E_CAMERAS),
            (["--num_devices", str(n_cards), "--shard_axis", "gauss"],
             f"--num_devices {n_cards} --shard_axis gauss", 3 * n_cards * N_E2E_CAMERAS)):
        ply, walk_ply = os.path.join(work, "spmd.ply"), os.path.join(work, "walk.ply")
        argv = e2e_argv(e2e["ply"], e2e["tj"], e2e["masks"], ply) + [
            "--surface_distance_std", "1e6"] + extra
        log.reset_phases()
        reset_launches()
        starts = launch.RANK_STARTS
        t0 = time.perf_counter()
        res = cli.main(argv)
        wall = time.perf_counter() - t0
        phases = {k: round(v, 4) for k, v in log.PHASE_SECONDS.items()}
        bringup = [k for k in phases if k.startswith("rank") and "/spmd_" in k]
        if launch.RANK_STARTS != starts or bringup or "spmd_dispatch" not in phases:
            fail(f"spmd CLI {label}: {launch.RANK_STARTS - starts} ranks started, bring-up "
                 f"phases {bringup}; expected the pool's ranks, kept")
        launches, by_rank = launched(), launches_by_rank()
        want = {"K1": want_k1, "K2": 2 * want_k1, "sorts": 2 * want_k1, "K5": n_cards,
                "K6": want_k1,
                "K6 alone": 0, "twin": 0}
        if launches != want or len(by_rank) != n_cards:
            fail(f"spmd CLI {label}: launches {launches} over {len(by_rank)} ranks "
                 f"{by_rank}, expected {want} over {n_cards}")
        n_file = check_cloud(res, ply, f"spmd CLI {label}")
        args = parse_args(argv)
        walk = pipeline._convert_walked(
            e2e["ply"], e2e["tj"], e2e["masks"], settings_from_args(args), device=device,
            num_devices=args.num_devices)
        save_point_cloud_ply(walk.cloud, walk_ply, chunk_size=10**6)
        if not files_equal(ply, walk_ply):
            fail(f"spmd CLI {label}: the PLY differs from the walk's")
        if walk.sweep_diag != res.sweep_diag:
            fail(f"spmd CLI {label}: counters {res.sweep_diag} vs the walk's {walk.sweep_diag}")
        os.remove(ply)
        os.remove(walk_ply)
        out[f"cli {label}"] = wall
        print(f"spmd CLI {label}: {n_file} points in {wall:.3f}s, PLY byte-equal to the walk's; "
              f"launches {launches}, [K1, K2, K5] per rank {by_rank}; phases "
              f"{json.dumps(phases)}",
              flush=True)
    return out


def same_bits(a, b) -> bool:
    """Every accumulator of ``a`` equal to ``b``'s, bit for bit."""
    import torch

    return all(torch.equal(getattr(a, n), getattr(b, n).to(getattr(a, n).device))
               for n in EXACT + ("total_contribution",))


def hold_split(label: str, acc, one, ref_adr, ref_sd) -> None:
    """Hold a split's accumulators to one device: the camera split exactly
    but for the total's summation order, a depth-slab or 2-D split as
    compare_sharded does."""
    import torch

    if "cameras" in label:
        for name in EXACT:
            if not torch.equal(getattr(acc, name).to(one.max_contribution.device),
                               getattr(one, name)):
                fail(f"{label}: {name} differs from one device")
        d = shard_diffs(acc.to(one.max_contribution.device), one)
        if d["total_contribution"] > TOL_SHARD_CONTRIB:
            fail(f"{label}: total contribution off by {d['total_contribution']}")
    else:
        compare_sharded(acc.to(one.max_contribution.device), ref_adr, ref_sd,
                        f"{label} sweep, {N_E2E_CAMERAS} cameras")


def phase_dryrun(device):
    """parallel.dryrun.dryrun_multichip(8) on [cuda:0] * 8, and on every card
    of a machine with several."""
    import torch

    from gs2pc_torch.parallel.dryrun import dryrun_multichip

    runs = [(N_DRYRUN_DEVICES, device)]
    if torch.cuda.device_count() > 1:
        runs.append((torch.cuda.device_count(), "cuda"))
    for n, dev in runs:
        reset_launches()
        t0 = time.perf_counter()
        verdicts = dryrun_multichip(n, dev)
        wall = time.perf_counter() - t0
        launches = launched()
        if launches["K1"] < 1 or launches["K2"] < 1 or launches["K6"] < 1:
            fail(f"dry run on {n} x {dev}: launches {launches}")
        print(f"dry run on {n} x {dev}: {len(verdicts)} axes OK in {wall:.3f}s; launches "
              f"{launches}", flush=True)


def phase_bench(work) -> dict:
    """The port's bench in this process (gs2pc_torch.bench.main, stdout
    captured) at its defaults, its gate at N_ORACLE_GAUSSIANS with a fresh
    oracle cache under ``work``; returns its K1, K2 and K5 launches."""
    import contextlib
    import io

    from gs2pc_torch import bench

    env = {k: v for k, v in os.environ.items() if not k.startswith("GS2PC_BENCH_")}
    env.update(GS2PC_BENCH_PSNR_GAUSS=str(N_ORACLE_GAUSSIANS),
               GS2PC_CACHE_DIR=os.path.join(work, "cache"),
               GS2PC_BENCH_DIR=os.path.join(work, "capture"))
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env, clear=True), contextlib.redirect_stdout(out):
        rc = bench.main()
    wall = time.perf_counter() - t0
    launches = read_launches()
    records = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    if not records:
        fail(f"the bench printed no record (exit {rc}): {out.getvalue()[-2000:]}")
    rec = records[-1]
    print(f"bench: {json.dumps(rec)}", flush=True)
    print(f"bench: {len(records)} records, exit {rc}, {wall:.1f}s in all; launches {launches}",
          flush=True)
    if rc != 0:
        fail(f"the bench exited {rc}")
    n_cams = 45
    if f"{n_cams}cam@{E2E_WIDTH}x{E2E_HEIGHT}" not in rec["metric"] or rec["steady"] is not True:
        fail(f"bench: not a steady run of the {n_cams}-camera cell: {rec['metric']}, "
             f"steady {rec['steady']}")
    n_file = read_ply_count(os.path.join(work, "capture", "cloud.ply"))
    if rec["points"] != n_file or abs(n_file - N_POINTS) > 0.01 * N_POINTS:
        fail(f"bench: {rec['points']} points in the record, {n_file} in the PLY, "
             f"for a budget of {N_POINTS}")
    if (rec["blend"], rec["sampler"], rec["writer"]) != ("cuda", "k5", "native_stream"):
        fail(f"bench: blend {rec['blend']}, sampler {rec['sampler']}, writer {rec['writer']}")
    if not (rec.get("psnr_gate_pass") is True and rec.get("psnr_oracle_coverage") == 1.0
            and rec["acc_contrib_relerr"] <= bench.ACC_RELERR_GATE
            and rec["acc_surf_underrun"] <= 0.0 and rec["acc_surf_bad_finite_frac"] <= 0.0):
        fail(f"bench: the gate did not pass whole: {rec}")
    # Two conversions (one K1, two K2 and one K6 a camera, one K5 each), then
    # the gate's one tile render; the gate's oracle launches K6 without a
    # table, once a band.
    want = {"blend_tiles": 2 * n_cams + 1, "duplicate_with_keys": 2 * 2 * n_cams + 2,
            "order_pairs": 2 * 2 * n_cams + 2,
            "sample_points": 2, "project_and_pack": 2 * n_cams + 1, "preprocess_torch": 0}
    if {k: launches[k] for k in want} != want or launches["preprocess"] < 1:
        fail(f"bench: kernel launches {launches}, expected {want} and K6 without a table "
             f"for the oracle")
    return launches


def phase_forensics(device, work, oracle):
    """pixel_forensics on the oracle phase's tile and oracle images (200k
    Gaussians, 1280x720): the float64 truth at the 12 worst pixels."""
    import numpy as np

    from gs2pc_torch.tools import pixel_forensics

    tile, dense = os.path.join(work, "tile.npz"), os.path.join(work, "oracle.npz")
    np.savez(tile, image=oracle["tile_image"])
    np.savez(dense, image=oracle["oracle_image"])
    t0 = time.perf_counter()
    recs = pixel_forensics.main([
        "--tile_npz", tile, "--oracle_npz", dense, "--gaussians", str(N_ORACLE_GAUSSIANS),
        "--seed", "0", "--width", str(E2E_WIDTH), "--height", str(E2E_HEIGHT),
        "--worst", str(N_FORENSIC_PIXELS), "--device", str(device)])
    wall = time.perf_counter() - t0
    sides = {}
    for r in recs:
        sides[r["side"]] = sides.get(r["side"], 0) + 1
    print(f"forensics: {len(recs)} worst pixels of the oracle phase in {wall:.3f}s (limit "
          f"{FORENSICS_LIMIT_S:g}s): {sides}; largest |tile - truth| "
          f"{max(r['err_tile'] for r in recs):.4g}, |oracle - truth| "
          f"{max(r['err_oracle'] for r in recs):.4g}", flush=True)
    if len(recs) != N_FORENSIC_PIXELS or not all(np.isfinite(r["truth"]).all() for r in recs):
        fail("forensics: missing or non-finite records")
    if wall > FORENSICS_LIMIT_S:
        fail(f"forensics took {wall:.1f}s > {FORENSICS_LIMIT_S:g}s")
    return dict(wall=wall, sides=sides)


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    from gs2pc_torch.ops import cuda_build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} card(s)", flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    ptxas = [ln.strip() for ln in cuda_build.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "stack frame" in ln]
    print(f"build: {time.perf_counter() - t0:.1f}s -> {cuda_build.BUILD_INFO['path']}; "
          + " | ".join(ptxas), flush=True)
    t0 = time.perf_counter()
    if cuda_build.load_plyio() is None:
        fail(f"the PLY writer did not build: {cuda_build.PLYIO_INFO.get('error')}")
    print(f"build: PLY writer {time.perf_counter() - t0:.1f}s -> "
          f"{cuda_build.PLYIO_INFO['path']}", flush=True)
    t0 = time.perf_counter()
    if cuda_build.load_mesher() is None:
        fail(f"the mesher did not build: {cuda_build.MESHER_INFO.get('error')}")
    print(f"build: mesher {time.perf_counter() - t0:.1f}s -> {cuda_build.MESHER_INFO['path']}",
          flush=True)

    probe_launches, k3, k4 = phase_probes(device)
    phase_k2(device)
    phase_k1(device)
    phase_k1_sh(device)
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        arrays, launches, e2e = phase_e2e(device, work)
        phase_transfers(device, work, e2e, smi)
        del e2e["cloud"]
        files = (e2e["tj"], e2e["masks"])
        sh = phase_sh(device, work, arrays, e2e["cols_u8"], *files)
        phase_mesh(device, work, e2e["ply"], *files)
        phase_auto_capacity(device, work, e2e["ply"], *files)
        phase_preview(device, work, e2e["ply"], e2e["tj"])
        phase_convert(work, e2e["ply"])
        ms, bounds, k1_err = phase_timing(device, arrays)
        k5 = phase_k5(device, arrays)
        k6 = phase_k6(device, arrays)
        slab = phase_slab(device, arrays)
        launches.update(phase_sharded(device, arrays))
        splits = phase_splits(device, arrays)
        del arrays
        phase_spmd(device, splits, e2e, work)
        del splits
    finally:
        shutil.rmtree(work, ignore_errors=True)
    oracle = phase_oracle(device)
    work = os.path.join(REPO, "build", "chip_smoke_dense")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        phase_dense_cli(device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_covariances(device)
    phase_dryrun(device)
    work = os.path.join(REPO, "build", "chip_smoke_forensics")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        phase_forensics(device, work, oracle)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = os.path.join(REPO, "build", "chip_smoke_bench")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        for name, n in phase_bench(work).items():
            launches[name] += n
    finally:
        shutil.rmtree(work, ignore_errors=True)
    decode = sh["decode"]

    def entry(name, source, replaces, n, err, t, plain, bound, launch=None, library=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": t, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library,
                "wrapper_ms": t, "launch_ms": launch}

    k1_src, k1_tpu = "gs2pc_torch/csrc/blend.cu", "gs2pc/ops/pallas_blend.py:808"
    record = {"kernels": [
        entry("blend_tiles", k1_src, k1_tpu, launches["blend_tiles"], k1_err,
              ms["blend_tiles"], ms["blend_tiles_torch"], bounds["blend_tiles"],
              ms["blend_tiles_launch"]),
        *(entry(f"blend_tiles[{m}]", k1_src, k1_tpu, launches[m], slab[m]["max_abs_err"],
                slab[m]["wrapper_ms"], slab[m]["plain_ms"], slab[m]["bound"],
                slab[m]["launch_ms"])
          for m in K1_MODES),
        entry("duplicate_with_keys", "gs2pc_torch/csrc/pairs.cu", "gs2pc/ops/rasterize.py:250",
              launches["duplicate_with_keys"], 0.0, ms["duplicate_with_keys"],
              ms["duplicate_with_keys_torch"], bounds["duplicate_with_keys"],
              ms["k2_count"] + ms["k2_write"]),
        entry("probe_op", "gs2pc_torch/csrc/probes.cu", "tools/pallas_probe.py:17",
              probe_launches["probe_op"], k3["max_abs_err"], k3["ms"], k3["plain_ms"],
              k3["bound"], k3["launch_ms"]),
        *(entry(f"probe_op[{op}]", "gs2pc_torch/csrc/probes.cu", "tools/pallas_probe.py:17",
                probe_launches[f"probe_op[{op}]"], k3["ops"][op]["max_abs_err"],
                k3["ops"][op]["ms"], k3["ops"][op]["plain_ms"], k3["bound"],
                k3["ops"][op]["launch_ms"], k3["ops"][op]["library_ms"])
          for op in ("roll", "scan")),
        entry("probe_blend", "gs2pc_torch/csrc/probes.cu", "tools/pallas_probe2.py:158",
              probe_launches["probe_blend"], k4["max_abs_err"], k4["ms"], k4["plain_ms"],
              k4["bound"], k4["launch_ms"]),
        entry("sample_points", "gs2pc_torch/csrc/sampler.cu", "gs2pc/ops/sampler.py:149",
              launches["sample_points"], k5["max_abs_err"], k5["wrapper_ms"], k5["plain_ms"],
              k5["bound"], k5["launch_ms"]),
        entry("project_and_pack", "gs2pc_torch/csrc/project.cu", "gs2pc/ops/projection.py:47",
              launches["project_and_pack"], k6["max_abs_err"], k6["wrapper_ms"],
              k6["plain_ms"], k6["bound"], k6["launch_ms"]),
        entry("ply_decode", "gs2pc_torch/csrc/plydecode.cu", "gs2pc/io/ply.py:157",
              decode["launches"], decode["max_abs_err"], decode["wrapper_ms"],
              decode["plain_ms"], decode["bound"], decode["launch_ms"]),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
