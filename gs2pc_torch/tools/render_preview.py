"""Render preview images and depth maps from a 3DGS scene (counterpart of
tools/render_preview.py): each camera through the tile renderer (K2 twice
and K1 once an image on a card), written as 8-bit PNG without imageio or
PIL (gs2pc_torch.utils.imaging).

    python -m gs2pc_torch.tools.render_preview --input_path scene.ply
        --transform_path sparse/0 [--out_dir previews] [--max_images 4]
        [--colour_quality medium] [--depth] [--device cuda:0]

Writes ``<name>.png`` per camera and, with ``--depth``, ``<name>_depth.png``
(the expected depth, min-max normalised).  ``main(argv)`` returns the paths
it wrote.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.io.colmap import load_transform_data
from gs2pc_torch.io.gaussians_io import load_gaussians
from gs2pc_torch.ops.rasterize import TileConfig, render_tile_camera
from gs2pc_torch.pipeline import set_precision
from gs2pc_torch.tools.validate_psnr import scene_arrays
from gs2pc_torch.utils.config import COLOR_QUALITY_OPTIONS
from gs2pc_torch.utils.imaging import imwrite


def normalised_depth(depth: np.ndarray) -> np.ndarray:
    """Min-max normalised depth in float32, as the JAX tool computes it."""
    dmin, dmax = depth.min(), depth.max()
    return (depth - dmin) / max(dmax - dmin, 1e-9)


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_path", required=True)
    ap.add_argument("--transform_path", required=True)
    ap.add_argument("--out_dir", default="previews")
    ap.add_argument("--max_images", type=int, default=4)
    ap.add_argument("--colour_quality", default="medium")
    ap.add_argument("--depth", action="store_true", help="also save depth maps")
    ap.add_argument("--max_sh_degree", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    set_precision()

    os.makedirs(args.out_dir, exist_ok=True)
    scene = scene_arrays(load_gaussians(args.input_path, max_sh_degree=args.max_sh_degree,
                                        device=device))
    transforms, intrinsics = load_transform_data(args.transform_path)
    names = list(transforms)[: args.max_images]
    cameras = build_camera_batch(
        {k: transforms[k] for k in names}, intrinsics,
        colour_resolution=COLOR_QUALITY_OPTIONS[args.colour_quality.lower()], device=device,
    )
    cfg = TileConfig(width_pad=cameras.width_pad, height_pad=cameras.height_pad)
    written = []
    for i, name in enumerate(names):
        cam = cameras.at(i)
        out = render_tile_camera(*scene, cam, cfg, calc_surface_distance=False)
        w, h = cam.width, cam.height
        path = os.path.join(args.out_dir, f"{name}.png")
        imwrite(path, out.image[:h, :w].cpu().numpy())
        written.append(path)
        if args.depth:
            path = os.path.join(args.out_dir, f"{name}_depth.png")
            imwrite(path, normalised_depth(out.depth[:h, :w].cpu().numpy()))
            written.append(path)
        print(f"wrote {name} ({w}x{h})", flush=True)
    return written


if __name__ == "__main__":
    main()
