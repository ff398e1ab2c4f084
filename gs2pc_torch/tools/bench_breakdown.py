"""Per-stage card times of the tile renderer and the sampler (counterpart
of tools/bench_breakdown.py), on the capture scene, timed with CUDA events
(a warm-up call, then the mean over ``--reps`` calls):

  preprocess                      projection, conic and tile rects
  preprocess + depth sort + K2    + the Gaussians' depth sort and the exact
                                  pair expansion in its order (no tile sort)
  + order_pairs + tile ranges     + the stable tile sort and the run bounds
  full sweep, K1 / twin,          every camera through render_sweep, with
    surface on / off              K1 or its PyTorch twin
  full sweep, K1, surface, masks  with the capture's vignette masks
  sampling                        quotas + sample_points for --points

    python -m gs2pc_torch.tools.bench_breakdown [--device cuda:0]
        [--gaussians 1000000] [--points 5000000] [--cams 2]
        [--width 1280] [--height 720] [--compact] [--reps 3]

The JAX tool's TPU pair-budget flags (--pair_budget_log2, --auto_budget)
and its aligned-pair row have no counterpart: the port's pair expansion is
exact and its tables are not aligned.  A card is required.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from gs2pc_torch.ops import blend_kernel, prng
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.projection import preprocess
from gs2pc_torch.ops.sampler import distribute_points, sample_points
from gs2pc_torch.pipeline import set_precision
from gs2pc_torch.sweep import init_accumulators, render_sweep, update_accumulators
from gs2pc_torch.tools.validate_psnr import capture_cameras, capture_scene, scene_arrays


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {stage: milliseconds (per camera for the per-camera stages)}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--points", type=int, default=5_000_000)
    ap.add_argument("--cams", type=int, default=2)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--compact", action="store_true",
                    help="production compact rgb24 tables + surface_compact")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        raise SystemExit("bench_breakdown times the card with CUDA events: --device must be "
                         "a CUDA device")
    torch.cuda.set_device(device)
    set_precision()
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)

    g = capture_scene(args.gaussians, args.seed, device).calculate_normals()
    scene = scene_arrays(g)
    cameras = capture_cameras(args.cams, args.width, args.height, device)
    cam = cameras.at(0)
    cfg = R.TileConfig(width_pad=cameras.width_pad, height_pad=cameras.height_pad,
                       run_cap=4096, run_chunk=128, compact=args.compact,
                       surface_compact=args.compact)
    ms = {}

    def show(name, value, per_cam=True):
        ms[name] = value
        print(f"{name + ':':40s}{value:10.3f} ms{'/cam' if per_cam else ''}", flush=True)

    def prep():
        return preprocess(scene.means, scene.cov_factors, scene.opacities, scene.alive, cam)

    def expand():
        p = prep()
        return R.duplicate_with_keys(p, cfg, True, R.depth_order(p.depth, p.valid))

    def binning():
        tiles, gids = R.order_pairs(prep(), cfg, circle_cull=True)
        return R.tile_ranges(tiles, cfg.num_tiles), gids

    show("preprocess", cuda_ms(prep, args.reps))
    show("preprocess + depth sort + K2 (no tile sort)", cuda_ms(expand, args.reps))
    show("preprocess + order_pairs + tile ranges", cuda_ms(binning, args.reps))

    n = cameras.num_cameras
    for name, blend in (("K1", blend_kernel.blend_tiles), ("twin", blend_kernel.blend_tiles_torch)):
        for surf in (False, True):
            def sweep(s=surf, blend=blend):
                # render_sweep's loop, with the blend chosen.
                acc = init_accumulators(args.gaussians, device=device)
                for i in range(n):
                    acc = update_accumulators(acc, R.render_tile_camera(
                        *scene, cameras.at(i), cfg, calc_surface_distance=s, blend=blend))
                return acc

            t = cuda_ms(sweep, args.reps if name == "K1" else 1)
            show(f"full sweep ({name}, surface={surf})", t / n)

    cameras_m = capture_cameras(args.cams, args.width, args.height, device, masks=True)
    show("full sweep (K1, surface, masks)", cuda_ms(
        lambda: render_sweep(scene, cameras_m, cfg, calc_surface_distance=True), args.reps) / n)

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    contrib = torch.randn(args.gaussians, device=device, generator=gen).abs()
    n_cap = args.points + args.points // 20

    def sampling():
        ppg = distribute_points(g.magnitudes(contributions=contrib), args.points)
        return sample_points(prng.PRNGKey(1), g, ppg, n_cap=n_cap).points

    show(f"point sampling ({args.points} pts)", cuda_ms(sampling, args.reps), per_cam=False)
    return ms


if __name__ == "__main__":
    main()
