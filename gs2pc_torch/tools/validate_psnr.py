"""PSNR validation: the tile renderer against the dense exact oracle, per
camera (counterpart of tools/validate_psnr.py).

Renders the same cameras with the tile renderer (K1 on a card, its twin on
the CPU) and with gs2pc_torch.ops.dense_render.render_dense, and reports
each camera's image PSNR, largest |image delta| and |contribution delta|,
the oracle's wall time, then the worst PSNR.  A scene file, or the capture
scene of gs2pc_torch.utils.capture with its orbit cameras.

    python -m gs2pc_torch.tools.validate_psnr [--device cuda:0]
        [--input_path scene.ply --transform_path sparse/0] [--cams 3]
        [--gaussians 20000] [--width 256] [--height 256] [--masks]
        [--production] [--rect_cull]

``--production`` renders the tiles at the conversion's defaults (compact
rgb24 tables, surface pass with surface_compact, run cap 4096) instead of
exact f32 colours without the surface pass; ``--rect_cull`` blends, in the
oracle, only the pairs whose tile lies in the Gaussian's rect, as the tile
renderer does.  ``main(argv)`` returns the numbers.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence

import torch

from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops.dense_render import render_dense
from gs2pc_torch.ops.rasterize import TileConfig, render_tile_camera
from gs2pc_torch.pipeline import set_precision
from gs2pc_torch.sweep import RenderArrays
from gs2pc_torch.utils import capture

VISUALLY_LOSSLESS_DB = 40.0  # tools/validate_psnr.py's line


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB of two [0, 1] images (inf when equal), in float64."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def scene_arrays(gaussians: Gaussians) -> RenderArrays:
    """What the renderers read, every Gaussian alive (as the JAX tools)."""
    return RenderArrays(
        gaussians.xyz, gaussians.covariance_factors(), gaussians.opacities, gaussians.colours,
        torch.ones(gaussians.num_gaussians, dtype=torch.bool, device=gaussians.device),
    )


def capture_scene(n: int, seed: int, device) -> Gaussians:
    a = capture.make_scene_arrays(n, seed=seed)
    return Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours, a.opacities,
                                device=device)


def capture_cameras(n_cams: int, width: int, height: int, device, masks: bool = False):
    """The capture's orbit cameras, with its vignette masks on request."""
    return capture.make_cameras(n_cams, width, height, with_masks=masks, device=device)[0]


def tile_config(width_pad: int, height_pad: int, production: bool, run_cap: int = 4096):
    return TileConfig(width_pad=width_pad, height_pad=height_pad, run_cap=run_cap,
                      run_chunk=128, compact=production, surface_compact=production)


def oracle(scene: RenderArrays, cam, width_pad: int, height_pad: int, rect_cull: bool,
           chunk: int = 256):
    """The dense render of one camera (no surface pass) and its wall time."""
    sync(scene.means.device)
    t0 = time.perf_counter()
    out = render_dense(*scene, cam, width_pad, height_pad, chunk=chunk,
                       calc_surface_distance=False, mask=cam.mask, rect_cull=rect_cull)
    sync(scene.means.device)
    return out, time.perf_counter() - t0


def compare(tile_out, dense_out, cam) -> dict:
    """PSNR and the largest deltas of a tile render against the oracle, over
    the camera's true image."""
    h, w = cam.height, cam.width
    a, b = tile_out.image[:h, :w], dense_out.image[:h, :w]
    return dict(
        psnr_db=psnr(a, b),
        max_image_delta=float((a - b).abs().max()),
        max_contrib_delta=float((tile_out.contrib - dense_out.contrib).abs().max()),
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"cameras": [per-camera records], "worst_psnr_db": ...}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--input_path", default=None)
    ap.add_argument("--transform_path", default=None)
    ap.add_argument("--max_sh_degree", type=int, default=3)
    ap.add_argument("--cams", type=int, default=3)
    ap.add_argument("--gaussians", type=int, default=20000,
                    help="capture scene size when no --input_path is given")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--masks", action="store_true", help="the capture's vignette masks")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--rect_cull", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    set_precision()

    if args.input_path:
        from gs2pc_torch.io.gaussians_io import load_gaussians

        g = load_gaussians(args.input_path, max_sh_degree=args.max_sh_degree, device=device)
    else:
        g = capture_scene(args.gaussians, args.seed, device)
    if args.transform_path:
        from gs2pc_torch.io.colmap import load_transform_data

        transforms, intr = load_transform_data(args.transform_path)
        names = list(transforms)[: args.cams]
        cameras = build_camera_batch({k: transforms[k] for k in names}, intr,
                                     colour_resolution=args.width, device=device)
    else:
        cameras = capture_cameras(args.cams, args.width, args.height, device, args.masks)
    scene = scene_arrays(g)
    cfg = tile_config(cameras.width_pad, cameras.height_pad, args.production)

    records = []
    for i in range(cameras.num_cameras):
        cam = cameras.at(i)
        out_t = render_tile_camera(*scene, cam, cfg, calc_surface_distance=args.production)
        out_d, dense_s = oracle(scene, cam, cfg.width_pad, cfg.height_pad, args.rect_cull)
        rec = dict(camera=i, **compare(out_t, out_d, cam), dense_s=dense_s)
        records.append(rec)
        print(f"cam {i}: PSNR {rec['psnr_db']:6.2f} dB   max |image delta| "
              f"{rec['max_image_delta']:.2e}   max |contrib delta| "
              f"{rec['max_contrib_delta']:.2e}   oracle {dense_s:.2f}s", flush=True)
    worst = min(r["psnr_db"] for r in records)
    print(f"\nworst-case PSNR vs exact oracle: {worst:.2f} dB "
          f"(>= {VISUALLY_LOSSLESS_DB:g} dB is visually lossless)", flush=True)
    return dict(cameras=records, worst_psnr_db=worst)


if __name__ == "__main__":
    main()
