"""Where does the tile render differ from the dense oracle? (counterpart
of tools/diff_map.py): per-pixel and per-16x16-tile error statistics of
the tile renderer (run cap 65536, exact f32 colours, surface pass with
surface_compact) against the oracle image that ablate_psnr caches, the
largest-error tiles, the rows over 0.1 (band seams would show as stripes
every band height), and the worst pixel.

    python -m gs2pc_torch.tools.diff_map [--device cuda:0]
        [--gaussians 1000000] [--width 1280] [--height 720]
        [--oracle_npz PATH] [--save_npz tile_image.npz]

Without a cached oracle it renders (and caches) one first.  ``main(argv)``
returns the statistics.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.blend import TILE
from gs2pc_torch.pipeline import set_precision
from gs2pc_torch.tools.ablate_psnr import (
    SCENE_SEED,
    default_cache,
    load_or_render_oracle,
    oracle_key,
    save_npz_atomic,
)
from gs2pc_torch.tools.validate_psnr import capture_cameras, capture_scene, scene_arrays

THRESHOLDS = (0.5, 0.1, 0.01, 1e-3)


def error_stats(img: torch.Tensor, oracle: torch.Tensor, width: int, height: int,
                band_rows: int) -> dict:
    """Per-pixel (max over channels) and per-tile error statistics over the
    true image."""
    d = (img[:height, :width] - oracle[:height, :width]).abs().amax(dim=2).cpu()
    th, tw = height // TILE, width // TILE
    dt = d[: th * TILE, : tw * TILE].reshape(th, TILE, tw, TILE).amax(dim=(1, 3))
    order = torch.argsort(dt.reshape(-1), descending=True, stable=True)[:20]
    iy, ix = divmod(int(torch.argmax(d)), width)
    rows_over = torch.nonzero(d.amax(dim=1) > 0.1).reshape(-1)
    return dict(
        max_err=float(d.max()),
        mean_err=float(d.double().mean()),
        px_over={t: int((d > t).sum()) for t in THRESHOLDS},
        tiles_over_0_1=int((dt > 0.1).sum()),
        num_tiles=th * tw,
        worst_tiles=[(int(o) // tw, int(o) % tw, float(dt.reshape(-1)[o])) for o in order],
        rows_over_0_1=rows_over[:50].tolist(),
        band_seam_rows_over_0_1=[int(r) for r in rows_over
                                 if int(r) % band_rows in (0, band_rows - 1)][:50],
        band_rows=band_rows,
        worst_pixel=(iy, ix, img[iy, ix].tolist(), oracle[iy, ix].tolist()),
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--oracle_npz", default=None, help="oracle cache (default under build/)")
    ap.add_argument("--save_npz", default=None, help="also save the tile image here")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    set_precision()

    scene = scene_arrays(capture_scene(args.gaussians, SCENE_SEED, device))
    cameras = capture_cameras(1, args.width, args.height, device)
    cam = cameras.at(0)
    wp, hp = cameras.width_pad, cameras.height_pad
    cache = args.oracle_npz or default_cache(args.gaussians, args.width, args.height)
    oracle = load_or_render_oracle(scene, cam, wp, hp, cache,
                                   oracle_key(args.gaussians, args.width, args.height))
    cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=65536, run_chunk=128,
                       compact=False, surface_compact=True)
    img = R.render_tile_camera(*scene, cam, cfg, calc_surface_distance=True).image
    if args.save_npz:
        save_npz_atomic(args.save_npz, image=img.cpu().numpy())

    s = error_stats(img.cpu(), oracle.cpu(), cam.width, cam.height, max(1, (1 << 16) // wp))
    print(f"max err {s['max_err']:.4f}  mean {s['mean_err']:.6f}")
    for t, n in s["px_over"].items():
        print(f"px with err > {t}: {n}")
    print(f"tiles with max err > 0.1: {s['tiles_over_0_1']} / {s['num_tiles']}")
    print("worst 20 tiles (ty, tx, err):")
    for ty, tx, e in s["worst_tiles"]:
        print(f"  ({ty:3d},{tx:3d}) err {e:.4f}")
    print("row marginal (err>0.1 rows):", s["rows_over_0_1"])
    print(f"rows_per_band = {s['band_rows']}; band-seam rows over 0.1:",
          s["band_seam_rows_over_0_1"])
    iy, ix, t_px, o_px = s["worst_pixel"]
    print(f"worst pixel ({iy},{ix}): tile={t_px} oracle={o_px}", flush=True)
    return s


if __name__ == "__main__":
    main()
