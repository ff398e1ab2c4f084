"""Per-pixel float64 ground truth of the tile render (counterpart of
tools/pixel_forensics.py).

For chosen pixels, re-derives the exact blend in numpy float64 straight
from the scene parameters, with the semantics of gs2pc_torch.ops.blend
(power <= 0, alpha = min(0.99, op * exp(power)), skip alpha < 1/255, stop
when T * (1 - alpha) < 1e-4 BEFORE compositing the trigger, white
background), Gaussians depth-sorted ascending with a stable index
tie-break and culled to their full 3-sigma tile rect.  Compares the truth
with a saved tile image (``tools/diff_map.py --save_npz``) and a saved
oracle image (``ablate_psnr``'s cache) at the pixels where the two differ
most, and says which side is wrong.

    python -m gs2pc_torch.tools.pixel_forensics --tile_npz tile.npz
        --oracle_npz oracle.npz [--gaussians 1000000] [--seed 2]
        [--width 1280] [--height 720] [--worst 12] [--device cuda:0]

The scene is the port's capture (utils/capture) at ``--gaussians`` and
``--seed`` (ablate_psnr's scene seed by default), its first orbit camera;
``--device`` builds it.  ``main(argv)`` returns one record per pixel.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gs2pc_torch.ops.blend import TILE
from gs2pc_torch.tools.ablate_psnr import SCENE_SEED
from gs2pc_torch.tools.validate_psnr import capture_cameras, capture_scene


class Prepared(NamedTuple):
    """The float64 preprocess of one camera, in blend order."""

    order: np.ndarray  # (n,) ids of the blendable Gaussians, by float32 depth, stable
    depth: np.ndarray  # (P,) view-space z
    pix: np.ndarray  # (P, 2) pixel-space centre
    conic: np.ndarray  # (P, 3) A, B, C
    opacity: np.ndarray  # (P,)
    colour: np.ndarray  # (P, 3)
    rect_min: np.ndarray  # (P, 2) inclusive tile min (x, y)
    rect_max: np.ndarray  # (P, 2) exclusive tile max (x, y)


def prepare(xyz, cov_factors, opacity, colour, camera) -> Prepared:
    """Float64 mirror of gs2pc_torch/ops/projection.py (the full 3-sigma
    radius) for a ``camera.Camera``: the JAX tool's preprocess."""
    viewm = camera.viewmatrix.double().cpu().numpy()
    projm = camera.projmatrix.double().cpu().numpy()
    tanfovx, tanfovy = float(camera.tanfovx), float(camera.tanfovy)
    fx, fy = float(camera.focal_x), float(camera.focal_y)
    W, H = camera.width, camera.height
    xyz = np.asarray(xyz, np.float64)
    M3 = np.asarray(cov_factors, np.float64)
    op = np.asarray(opacity, np.float64)

    Rv, tv = viewm[:3, :3], viewm[:3, 3]
    p_view = xyz @ Rv.T + tv
    depth = p_view[:, 2]
    ph = xyz @ projm[:3, :3].T + projm[:3, 3]
    pw = xyz @ projm[3, :3].T + projm[3, 3]
    inv_w = 1.0 / (pw + 1e-7)
    pix = np.stack(
        [((ph[:, 0] * inv_w + 1.0) * W - 1.0) * 0.5,
         ((ph[:, 1] * inv_w + 1.0) * H - 1.0) * 0.5], axis=1)

    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    tz = np.where(np.abs(depth) < 1e-6, 1e-6, depth)
    tx = np.clip(p_view[:, 0] / tz, -limx, limx) * tz
    ty = np.clip(p_view[:, 1] / tz, -limy, limy) * tz
    T0 = np.einsum("ij,pjk->pik", Rv, M3)
    inv_z = 1.0 / tz
    row0 = (fx * inv_z)[:, None] * T0[:, 0, :] - (fx * tx * inv_z**2)[:, None] * T0[:, 2, :]
    row1 = (fy * inv_z)[:, None] * T0[:, 1, :] - (fy * ty * inv_z**2)[:, None] * T0[:, 2, :]
    cov_a = np.sum(row0 * row0, -1) + 0.3
    cov_b = np.sum(row0 * row1, -1)
    cov_c = np.sum(row1 * row1, -1) + 0.3
    det = cov_a * cov_c - cov_b * cov_b
    ok = (depth > 0.2) & (det > 0)
    det_s = np.where(ok, det, 1.0)
    conic = np.stack([cov_c / det_s, -cov_b / det_s, cov_a / det_s], axis=1)

    mid = 0.5 * (cov_a + cov_c)
    lam = mid + np.sqrt(np.maximum(0.1, mid * mid - det))
    radius = np.ceil(np.sqrt(9.0 * np.maximum(lam, 0.0)))
    ok &= op >= 1.0 / 255.0

    # The JAX tool's rect bounds, its x limit included (W // 16).
    def tile(v, hi):
        return np.clip(np.floor(v / TILE), 0, hi).astype(np.int64)

    gx, gy = W // TILE, (H + TILE - 1) // TILE
    rect_min = np.stack([tile(pix[:, 0] - radius, gx), tile(pix[:, 1] - radius, gy)], axis=1)
    rect_max = np.stack([tile(pix[:, 0] + radius + TILE - 1, gx),
                         tile(pix[:, 1] + radius + TILE - 1, gy)], axis=1)
    order = np.argsort(np.where(ok, depth, np.inf).astype(np.float32), kind="stable")
    return Prepared(order[: int(ok.sum())], depth, pix, conic, op,
                    np.asarray(colour, np.float64), rect_min, rect_max)


def blend_pixel(prep: Prepared, px_x: int, px_y: int, rect_cull: bool = True,
                dtype=np.float64):
    """The full blend at one pixel: (rgb, Gaussians blended, per blended
    Gaussian (id, depth, alpha, weight, colour)).  The culls are vectorised;
    the compositing walks the survivors in depth order."""
    g = prep.order
    if rect_cull:
        tx, ty = px_x // TILE, px_y // TILE
        lo, hi = prep.rect_min[g], prep.rect_max[g]
        g = g[(lo[:, 0] <= tx) & (tx < hi[:, 0]) & (lo[:, 1] <= ty) & (ty < hi[:, 1])]
    dx = dtype(px_x) - prep.pix[g, 0].astype(dtype)
    dy = dtype(px_y) - prep.pix[g, 1].astype(dtype)
    con = prep.conic[g].astype(dtype)
    power = dtype(-0.5) * (con[:, 0] * dx * dx + con[:, 2] * dy * dy) - con[:, 1] * dx * dy
    with np.errstate(over="ignore"):
        alpha = np.minimum(dtype(0.99), prep.opacity[g].astype(dtype) * np.exp(power))
    keep = (power <= 0) & (alpha >= dtype(1.0 / 255.0))
    trans = dtype(1.0)
    rgb = np.zeros(3, dtype)
    log = []
    for gi, a in zip(g[keep], alpha[keep]):
        if trans * (dtype(1.0) - a) < dtype(1e-4):
            break
        w = a * trans
        rgb += w * prep.colour[gi].astype(dtype)
        trans *= dtype(1.0) - a
        log.append((int(gi), float(prep.depth[gi]), float(a), float(w),
                    prep.colour[gi].tolist()))
    rgb += trans  # white background
    return rgb, len(log), log


def side_at_fault(err_tile: float, err_oracle: float) -> str:
    if err_tile > 10 * err_oracle:
        return "TILE wrong"
    return "ORACLE wrong" if err_oracle > 10 * err_tile else "both off"


def forensics(prep: Prepared, tile_img: np.ndarray, oracle: np.ndarray, width: int,
              height: int, worst: int = 12) -> list:
    """The truth at the ``worst`` pixels where the two images differ most."""
    d = np.abs(tile_img[:height, :width] - oracle[:height, :width]).max(axis=2)
    recs = []
    for o in np.argsort(-d.ravel(), kind="stable")[:worst]:
        py, px = divmod(int(o), width)
        truth, n_bl, log = blend_pixel(prep, px, py)
        t_px, o_px = tile_img[py, px], oracle[py, px]
        et, eo = float(np.abs(t_px - truth).max()), float(np.abs(o_px - truth).max())
        recs.append(dict(pixel=(py, px), truth=truth.tolist(), tile=t_px.tolist(),
                         oracle=o_px.tolist(), err_tile=et, err_oracle=eo, n_blend=n_bl,
                         side=side_at_fault(et, eo), log=log[:8]))
    return recs


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile_npz", required=True, help="tools/diff_map.py --save_npz output")
    ap.add_argument("--oracle_npz", required=True, help="ablate_psnr's oracle cache")
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=SCENE_SEED)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--worst", type=int, default=12)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    g = capture_scene(args.gaussians, args.seed, device)
    cam = capture_cameras(1, args.width, args.height, device).at(0)
    prep = prepare(g.xyz.cpu().numpy(), g.covariance_factors().cpu().numpy(),
                   g.opacities.cpu().numpy(), g.colours.cpu().numpy(), cam)
    with np.load(args.tile_npz) as z:
        tile_img = z["image"]
    with np.load(args.oracle_npz) as z:
        oracle = z["image"]
    recs = forensics(prep, tile_img, oracle, cam.width, cam.height, args.worst)
    for r in recs:
        (py, px), rnd = r["pixel"], (lambda v: np.round(v, 4))
        print(f"px({py:3d},{px:4d}) truth={rnd(r['truth'])} tile={rnd(r['tile'])} "
              f"oracle={rnd(r['oracle'])} |tile-truth|={r['err_tile']:.4f} "
              f"|oracle-truth|={r['err_oracle']:.4f} n_blend={r['n_blend']}  -> {r['side']}",
              flush=True)
        if r["err_tile"] > 0.05 and r["err_oracle"] > 0.05:
            for rec in r["log"]:
                print("   ", rec)
    return recs


if __name__ == "__main__":
    main()
