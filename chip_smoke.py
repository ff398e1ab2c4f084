"""Smoke test of gs2pc_torch on one CUDA GPU: builds the kernels, holds each
against its plain PyTorch twin, runs the production conversion end to end
through ``gs2pc_torch.cli.main`` and checks what it wrote.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    nvcc build + load of gs2pc_torch/csrc/*.cu
  3. K2       pair expansion vs twin: 200k Gaussians, one 1280x720 camera,
              sorted keys and gids equal exactly (surface and AdR modes)
  4. K1       tile blend vs twin: 20k Gaussians at 256x192, vignette mask,
              surface pass, compact tables on and off
  5. e2e      bench.py's capture (3M Gaussians, 16 cameras at 1280x720,
              masks) -> 10M points with surface distances on
  6. timing   K1 and K2 on camera 0 of that scene, the shape the main path
              gives them: held against their twins with the bounds of
              phases 3-4, then timed against them
The line before the last is the kernels' JSON record (max_abs_err at the
shape of phase 6), the last line the device record.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_E2E_GAUSSIANS = 3_000_000
N_E2E_CAMERAS = 16  # bench.py's north star has 45; cut so the build and checks fit
E2E_WIDTH, E2E_HEIGHT = 1280, 720
N_POINTS = 10_000_000

# Twin bounds.  Sequential (kernel) vs cumprod (twin) transmittance and
# expf vs torch.exp round differently, so floats agree to a few ulps of
# the accumulated sums; a near-tie in a pair's max contribution can pick
# another pixel, so best colour is held on a share of the Gaussians.
TOL_IMAGE = 1e-5
TOL_CONTRIB = 1e-6
TOL_SURF = 1e-5
TOL_BEST = 1e-5
BEST_SHARE = 0.999


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
    import bench
    from gs2pc_torch.camera import build_camera_batch

    transforms, intr = bench.make_poses(n_cams, width, height)
    masks = None
    if with_masks:
        m = bench.vignette_mask(width, height)
        masks = {name: m for name in transforms}
    return build_camera_batch(transforms, intr, masks=masks, device=device)


def blend_inputs(g, cam, cfg):
    """K1's inputs for one camera, built by the port's own stages (surface on)."""
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess

    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True)
    return prep, args, kw


def phase_k2(device):
    import bench
    import torch

    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess

    g = scene_on_device(bench.make_scene_arrays(200_000, seed=1), device)
    cams = camera_batch(1, E2E_WIDTH, E2E_HEIGHT, device, with_masks=False)
    cam = cams.at(0)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    n_pairs = []
    for surface in (True, False):
        prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                          adaptive_radius=not surface)
        kk, kg = R.sort_pairs(*R.duplicate_with_keys(prep, cfg, circle_cull=not surface))
        tk, tg = R.sort_pairs(*R.duplicate_with_keys_torch(prep, cfg, circle_cull=not surface))
        torch.cuda.synchronize()
        if not (torch.equal(kk, tk) and torch.equal(kg, tg)):
            fail(f"K2 disagrees with its twin (surface={surface}): "
                 f"{kk.numel()} vs {tk.numel()} pairs")
        n_pairs.append(kk.numel())
    print(f"K2 vs twin: 200k Gaussians, 1280x720: sorted keys and gids equal exactly "
          f"({n_pairs[0]} pairs full-rect, {n_pairs[1]} pairs AdR-culled)", flush=True)


def compare_k1(k, t, label: str) -> float:
    """Hold K1's outputs ``k`` against its twin's ``t``; print one line, fail
    on any miss, return the largest float difference."""
    import numpy as np

    from gs2pc_torch.ops.blend import FLOAT_MAX

    errs = {
        name: float((getattr(k, name) - getattr(t, name)).abs().max())
        for name in ("image", "depth", "invdepth", "contrib")
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
    bounds = dict(image=TOL_IMAGE, depth=TOL_IMAGE, invdepth=TOL_IMAGE,
                  contrib=TOL_CONTRIB, surf_dist=TOL_SURF)
    shown = " ".join(f"{n}={v:.3g}(<={bounds[n]:g})" for n, v in errs.items())
    print(f"K1 vs twin, {label}: {shown} surf_dist finite on different Gaussians: "
          f"{n_fin_diff}; best_colour off on {off}/{n_hit} Gaussians "
          f"(<= {1 - BEST_SHARE:.1%})", flush=True)
    if n_fin_diff:
        fail(f"K1 surface distances finite on different Gaussians ({label})")
    for n, v in errs.items():
        if not np.isfinite(v) or v > bounds[n]:
            fail(f"K1 {n} differs from its twin by {v} > {bounds[n]} ({label})")
    if n_hit == 0 or off > (1 - BEST_SHARE) * n_hit:
        fail(f"K1 best colour differs on {off}/{n_hit} Gaussians ({label})")
    return max(errs.values())


def phase_k1(device):
    import bench
    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops.rasterize import TileConfig

    g = scene_on_device(bench.make_scene_arrays(20_000, seed=2), device)
    cams = camera_batch(1, 256, 192, device, with_masks=True)
    cam = cams.at(0)
    for compact, surface_compact in ((True, True), (False, True), (True, False)):
        cfg = TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                         compact=compact, surface_compact=surface_compact)
        _, args, kw = blend_inputs(g, cam, cfg)
        k = B.blend_tiles(*args, **kw)
        t = B.blend_tiles_torch(*args, **kw)
        torch.cuda.synchronize()
        compare_k1(k, t, f"20k Gaussians 256x192, compact={compact} "
                         f"surface_compact={surface_compact}")


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


def phase_e2e(device, work):
    import bench
    import numpy as np

    from gs2pc_torch import cli
    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.utils import log

    t0 = time.perf_counter()
    arrays = bench.make_scene_arrays(N_E2E_GAUSSIANS)
    transforms, intr = bench.make_poses(N_E2E_CAMERAS, E2E_WIDTH, E2E_HEIGHT)
    ply, tj, mask_dir = bench.write_capture(work, arrays, transforms, intr, with_masks=True)
    out = os.path.join(work, "cloud.ply")
    print(f"e2e capture written in {time.perf_counter() - t0:.1f}s "
          f"({N_E2E_GAUSSIANS} Gaussians, {N_E2E_CAMERAS} cameras)", flush=True)

    log.reset_phases()
    B.blend_tiles.launches = 0
    R.duplicate_with_keys.launches = 0
    t0 = time.perf_counter()
    result = cli.main([
        "--input_path", ply, "--transform_path", tj, "--mask_path", mask_dir,
        "--output_path", out, "--num_points", str(N_POINTS),
        "--surface_distance_std", "1e6", "--seed", "0", "--quiet",
    ])
    wall = time.perf_counter() - t0
    launches = {"blend_tiles": B.blend_tiles.launches,
                "duplicate_with_keys": R.duplicate_with_keys.launches}

    cloud = result.cloud
    want = {"blend_tiles": N_E2E_CAMERAS, "duplicate_with_keys": 2 * N_E2E_CAMERAS}
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")
    n_file = read_ply_count(out)
    quota_sum = int(cloud.counts.sum())
    if not (n_file == cloud.total == quota_sum):
        fail(f"points written {n_file}, cloud {cloud.total}, quota sum {quota_sum}")
    if abs(n_file - N_POINTS) > 0.01 * N_POINTS:
        fail(f"{n_file} points written for a budget of {N_POINTS}")
    if not np.isfinite(cloud.points).all():
        fail("non-finite point positions")
    zmax = mahalanobis_max(cloud, arrays)
    if zmax > 2.0 + 1e-3:
        fail(f"a sampled point lies {zmax} deviations from its Gaussian (> 2)")
    phases = {k: round(v, 3) for k, v in log.PHASE_SECONDS.items()}
    print(f"e2e: {n_file} points (quota sum {quota_sum}) in {wall:.2f}s, "
          f"{n_file / wall:,.0f} points/s disk to disk; launches {launches}; "
          f"counters [pairs, win_drop, cap_drop, cap_live] = {result.sweep_diag}; "
          f"max sampled |z| {zmax:.4f}; phases {json.dumps(phases)}", flush=True)
    return arrays, launches


def phase_timing(device, arrays):
    """K1 and K2 on camera 0 of the e2e scene, the shape the main path gives
    them: outputs held against the twins, then timed."""
    import torch

    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R

    g = scene_on_device(arrays, device)
    cams = camera_batch(1, E2E_WIDTH, E2E_HEIGHT, device, with_masks=True)
    cam = cams.at(0)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                       compact=True, surface_compact=True)
    prep, args, kw = blend_inputs(g, cam, cfg)
    n_pairs = int(args[1].numel())
    label = f"camera 0 of the e2e scene ({n_pairs} pairs)"

    kk, kg = R.sort_pairs(*R.duplicate_with_keys(prep, cfg, False))
    tk, tg = R.sort_pairs(*R.duplicate_with_keys_torch(prep, cfg, False))
    torch.cuda.synchronize()
    if not (torch.equal(kk, tk) and torch.equal(kg, tg)):
        fail(f"K2 disagrees with its twin on {label}: {kk.numel()} vs {tk.numel()} pairs")
    print(f"K2 vs twin, {label}: sorted keys and gids equal exactly", flush=True)
    del kk, kg, tk, tg

    k = B.blend_tiles(*args, **kw)
    t = B.blend_tiles_torch(*args, **kw)
    torch.cuda.synchronize()
    k1_err = compare_k1(k, t, label)
    del k, t

    ms = {
        "duplicate_with_keys": cuda_ms(lambda: R.duplicate_with_keys(prep, cfg, False), 5),
        "duplicate_with_keys_torch": cuda_ms(
            lambda: R.duplicate_with_keys_torch(prep, cfg, False), 2),
        "blend_tiles": cuda_ms(lambda: B.blend_tiles(*args, **kw), 5),
        "blend_tiles_torch": cuda_ms(lambda: B.blend_tiles_torch(*args, **kw), 1),
    }
    print(f"timing, {label}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
    return ms, k1_err


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    import bench  # noqa: F401  (the capture helpers; numpy only)
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
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    ptxas = [ln.strip() for ln in cuda_build.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"build: {time.perf_counter() - t0:.1f}s -> {cuda_build.BUILD_INFO['path']}; "
          + " | ".join(ptxas), flush=True)

    phase_k2(device)
    phase_k1(device)
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        arrays, launches = phase_e2e(device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ms, k1_err = phase_timing(device, arrays)

    record = {"kernels": [
        {"name": "blend_tiles", "route": "cuda", "source": "gs2pc_torch/csrc/blend.cu",
         "replaces": "gs2pc/ops/pallas_blend.py:808", "launches": launches["blend_tiles"],
         "max_abs_err": k1_err, "ms": ms["blend_tiles"], "plain_ms": ms["blend_tiles_torch"]},
        {"name": "duplicate_with_keys", "route": "cuda", "source": "gs2pc_torch/csrc/pairs.cu",
         "replaces": "gs2pc/ops/rasterize.py:250",
         "launches": launches["duplicate_with_keys"], "max_abs_err": 0.0,
         "ms": ms["duplicate_with_keys"], "plain_ms": ms["duplicate_with_keys_torch"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
