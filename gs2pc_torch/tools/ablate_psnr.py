"""PSNR ablation: which production knob costs quality? (counterpart of
tools/ablate_psnr.py, with the same config matrix).

Renders the capture scene's first camera with the exact dense oracle once
(in bands of pixel rows, ``render_dense(block_range=...)``, with rect
culling; cached in an .npz that is written to a temporary file and then
renamed into place, so a cut run never leaves a torn cache, and that
carries the scene seed, size, camera and a hash of the sources that made
it, so another scene or oracle renders it again), then renders
it with the tile renderer in each config and prints one JSON line per
config: PSNR against the oracle, the four counters [pairs blended, window
drops, run-cap drops, run-cap drops on live tiles] and the render's wall
time on the device (a warm second render, synchronised).

  name                 run cap  compact  blend   surface_compact
  prod                 4096     on       K1      on
  cap16384             16384    on       K1      on
  cap65536             65536    on       K1      on
  nocompact            4096     off      K1      on
  twin                 4096     on       twin    on     (K1's PyTorch twin)
  noscomp              4096     on       K1      off
  cap65536+nocompact   65536    off      K1      on

    python -m gs2pc_torch.tools.ablate_psnr [--device cuda:0]
        [--gaussians 1000000] [--width 1280] [--height 720]
        [--configs prod,twin] [--oracle_npz PATH]

The default cache lives under the checkout's build/gs2pc_torch/.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gs2pc_torch.ops import blend_kernel
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.ops.dense_render import render_dense
from gs2pc_torch.pipeline import set_precision
from gs2pc_torch.tools.validate_psnr import (
    capture_cameras,
    capture_scene,
    psnr,
    scene_arrays,
    sync,
)

# name -> (run_cap, compact, K1's twin instead of K1, surface_compact)
CONFIGS = {
    "prod": (4096, True, False, True),
    "cap16384": (16384, True, False, True),
    "cap65536": (65536, True, False, True),
    "nocompact": (4096, False, False, True),
    "twin": (4096, True, True, True),
    "noscomp": (4096, True, False, False),
    "cap65536+nocompact": (65536, False, False, True),
}
SCENE_SEED = 2  # the JAX tool's scene seed
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "gs2pc_torch")
# The sources that decide the oracle image: the scene and its cameras, the
# projection and the dense blend, and the banding here.
ORACLE_SOURCES = (
    "utils/capture.py", "models/gaussians.py", "camera.py", "ops/projection.py",
    "ops/blend.py", "ops/dense_render.py", "tools/validate_psnr.py", "tools/ablate_psnr.py",
)


def default_cache(n_gauss: int, width: int, height: int) -> str:
    return os.path.join(BUILD_DIR,
                        f"ablate_oracle_s{SCENE_SEED}_{n_gauss}_{width}x{height}.npz")


def oracle_key(n_gauss: int, width: int, height: int) -> str:
    """What a cached oracle must have been rendered from: the scene (seed,
    size), the camera and a hash of ORACLE_SOURCES."""
    h = hashlib.sha256()
    for rel in ORACLE_SOURCES:
        with open(os.path.join(PACKAGE_DIR, rel), "rb") as f:
            h.update(f.read())
    return f"seed={SCENE_SEED} gaussians={n_gauss} {width}x{height} src={h.hexdigest()[:16]}"


def save_npz_atomic(path: str, **arrays) -> None:
    """np.savez_compressed into a temporary file beside ``path``, then an
    atomic rename: a reader sees the old file or the whole new one."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(os.path.abspath(path)))
    os.close(fd)
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def banded_oracle(scene, cam, width_pad: int, height_pad: int) -> torch.Tensor:
    """The oracle image, band by band of whole pixel rows (rect culling, no
    surface pass)."""
    rows = max(1, (1 << 16) // width_pad)
    blk = rows * width_pad
    n_blk = -(-(height_pad * width_pad) // blk)
    bands = []
    t0 = time.perf_counter()
    for b in range(n_blk):
        bands.append(render_dense(
            *scene, cam, width_pad, height_pad, chunk=256, pixel_chunk=blk,
            calc_surface_distance=False, mask=cam.mask, rect_cull=True, block_range=(b, 1),
        ).image)
        print(f"  oracle band {b + 1}/{n_blk} ({time.perf_counter() - t0:.1f}s)",
              file=sys.stderr, flush=True)
    return torch.cat(bands)[:height_pad]


def load_or_render_oracle(scene, cam, width_pad, height_pad, cache_path: Optional[str],
                          key: str):
    """The cached oracle image when the cache was rendered from ``key``
    (oracle_key) at this shape, else a fresh render, cached with its key."""
    shape = (height_pad, width_pad, 3)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            cached_key = str(z["key"]) if "key" in z.files else None
            img = z["image"]
        if cached_key == key and img.shape == shape:
            return torch.tensor(img, device=scene.means.device)
        print(f"oracle cache {cache_path} is from another scene or oracle source "
              f"({cached_key}); rendering it again", file=sys.stderr, flush=True)
    img = banded_oracle(scene, cam, width_pad, height_pad)
    if cache_path:
        save_npz_atomic(cache_path, image=img.cpu().numpy(), key=np.array(key))
    return img


def render_config(scene, cam, cfg, use_twin: bool):
    """One tile render with the surface pass, through K1 or its twin."""
    blend = blend_kernel.blend_tiles_torch if use_twin else blend_kernel.blend_tiles
    return R.render_tile_camera(*scene, cam, cfg, calc_surface_distance=True, blend=blend)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Returns the per-config records, in CONFIGS order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--configs", default=None, help="comma list of config names (default all)")
    ap.add_argument("--oracle_npz", default=None, help="oracle cache (default under build/)")
    args = ap.parse_args(argv)
    only = set(args.configs.split(",")) if args.configs else set(CONFIGS)
    unknown = only - set(CONFIGS)
    if unknown:
        raise ValueError(f"unknown configs {sorted(unknown)}; one of {list(CONFIGS)}")
    device = torch.device(args.device)
    set_precision()

    scene = scene_arrays(capture_scene(args.gaussians, SCENE_SEED, device))
    cameras = capture_cameras(1, args.width, args.height, device)
    cam = cameras.at(0)
    wp, hp = cameras.width_pad, cameras.height_pad
    cache = args.oracle_npz or default_cache(args.gaussians, args.width, args.height)
    print("rendering oracle...", file=sys.stderr, flush=True)
    oracle = load_or_render_oracle(scene, cam, wp, hp, cache,
                                   oracle_key(args.gaussians, args.width, args.height))

    records = []
    for name, (cap, compact, twin, scomp) in CONFIGS.items():
        if name not in only:
            continue
        cfg = R.TileConfig(width_pad=wp, height_pad=hp, run_cap=cap, run_chunk=128,
                           compact=compact, surface_compact=scomp)
        render_config(scene, cam, cfg, twin)  # warm-up
        sync(device)
        t0 = time.perf_counter()
        out = render_config(scene, cam, cfg, twin)
        sync(device)
        dt = time.perf_counter() - t0
        diag = [float(x) for x in out.n_dropped.cpu()]
        h, w = cam.height, cam.width
        rec = {
            "config": name,
            "psnr_db": psnr(out.image[:h, :w], oracle[:h, :w]),
            "t_render_s": dt,
            "pairs_blended": diag[0],
            "window_dropped": diag[1],
            "runcap_dropped": diag[2],
            "runcap_dropped_live": diag[3],
            "device": str(device),
        }
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
