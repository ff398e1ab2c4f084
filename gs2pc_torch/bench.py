"""The port's end-to-end benchmark (counterpart of the JAX package's
bench.py), at the north-star definition (BASELINE.json):

  3M-Gaussian scene -> 10M-point coloured cloud on disk, 45 cameras at
  1280x720 (colour_resolution 1280), surface distances on, pixel masks
  exercised, visibility-prioritised budgeting.

    python -m gs2pc_torch.bench

The timed path is the port's pipeline as gs2pc_torch.cli.main runs it on
one device: the scene .ply read from disk, transforms.json and the PNG
masks, the render sweep (K2 and K1 per camera), the cull chain, the PSD
clamp, the sampler (K5) and the chunked PLY write.  Two conversions run;
the second is the headline and the first, kernel builds included where
build/ holds none, is reported as ``t_cold_s``.

An at-scale quality gate renders one 1280x720 camera of a 1M-Gaussian
capture scene (seed 2, no mask) with the production tile renderer
(compact rgb24 tables, run cap 4096, surface pass) against the exact
dense oracle, rendered in bands of whole pixel rows and cached on disk.
The bench fails (exit 1, after printing its record) below 40 dB PSNR, or
when the per-Gaussian max-contribution and min-surface-distance
accumulators the cull chain consumes leave their gates.

``vs_baseline`` is measured against the north-star rate derived from
BASELINE.json: 10M points in 30 s, 333,333 points/s.

The bench prints its JSON record after every completed stage (read the
last line) and keeps an internal deadline (GS2PC_BENCH_DEADLINE_S, 420 s):
a stage that cannot fit is skipped, the oracle's bands stop in time, and
a partial oracle is cached so that the next run completes it.

It runs on GS2PC_BENCH_DEVICE (default cuda:0) and refuses to start when
that is a CUDA device and none is available: there is no CPU fallback.
GS2PC_BENCH_DEVICE=cpu runs it on the CPU with the kernels' PyTorch twins,
as the tests do.  The record differs from the JAX bench's as follows:
``t_probe_s`` reads 0.0, since the port has no pair-budget probe (the
budget exists for the TPU build's fixed shapes); ``sampler_reason`` and
``write_sink`` are gone, since the TPU link policy and the O_DIRECT sink
they describe are not ported; ``blend`` is "cuda" (K1) or "torch" (its
twin) and ``sampler`` "k5" or "torch", each read from the wrappers' launch
counts; stage 4 writes ``torch_sweep_s``; and it adds ``power_limit``
(nvidia-smi's name and power limit of the card), ``peak_device_bytes``
(the conversion's torch.cuda.max_memory_allocated) and ``t_gate_s`` (the
gate's wall).

Env knobs: GS2PC_BENCH_GAUSSIANS (3,000,000), GS2PC_BENCH_POINTS
(10,000,000), GS2PC_BENCH_CAMERAS (45), GS2PC_BENCH_WIDTH (1280),
GS2PC_BENCH_HEIGHT (720), GS2PC_BENCH_SURFACE (1), GS2PC_BENCH_MASKS (1),
GS2PC_BENCH_PSNR (1), GS2PC_BENCH_PSNR_GAUSS (1,000,000),
GS2PC_BENCH_SCENE (capture | ball), GS2PC_BENCH_COMPARE (1: also time the
sweep with K1's PyTorch twin, as ``torch_sweep_s``; default 0),
GS2PC_BENCH_DIR (where the capture is written; default a temporary
directory), GS2PC_BENCH_DEADLINE_S (420), GS2PC_BENCH_DEVICE (cuda:0).
GS2PC_BENCH_PALLAS tunes the TPU build only: it warns and does nothing.
The oracle cache lives under GS2PC_CACHE_DIR when that is set (the empty
string disables it), else under the checkout's build/gs2pc_torch/.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

from gs2pc_torch import pipeline
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import blend_kernel
from gs2pc_torch.ops import sampler as S
from gs2pc_torch.ops.dense_render import render_dense
from gs2pc_torch.ops.rasterize import TileConfig, render_tile_camera
from gs2pc_torch.sweep import init_accumulators, update_accumulators
from gs2pc_torch.tools.ablate_psnr import save_npz_atomic
from gs2pc_torch.tools.validate_psnr import capture_scene, scene_arrays, sync
from gs2pc_torch.utils import capture, log
from gs2pc_torch.utils.config import GaussPointCloudSettings

NORTH_STAR_POINTS_PER_S = 10_000_000 / 30.0
PSNR_GATE_DB = 40.0
# The accumulator gate: max relative error of the per-Gaussian max
# contribution (tile against the banded dense oracle) that the cull chain
# consumes.
ACC_RELERR_GATE = 0.05
# float32's max: the renderers' "never on any surface" sentinel.
FLOAT_MAX_BENCH = float(np.finfo(np.float32).max)
# Per-(pair, pixel) blend operations for blend_mfu_est: power 6, exp ~8,
# alpha / stop test 4, colour / depth / inverse-depth sums 10,
# transmittance 2.
FLOPS_PER_PAIR_PIXEL = 30.0
TPX = 256  # pixels per 16x16 tile
# Peak float32 rate outside the tensor cores by card name (NVIDIA's data
# sheet, H100 SXM at 700 W): the blend is fp32 work.  A card not listed
# gets no estimate.
PEAK_FLOPS_BY_KIND = {"H100 80GB HBM3": 67e12}
DEADLINE_S = 420.0
# The gate's scene seed, and the most pixels one oracle band renders (in
# whole rows).
ORACLE_SEED = 2
BAND_PIXELS = 1 << 16
PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "gs2pc_torch")
# The sources that decide the oracle: the scene and its camera, the
# projection and the dense blend, and the banding here.
ORACLE_SOURCES = (
    "utils/capture.py", "models/gaussians.py", "camera.py", "ops/projection.py",
    "ops/blend.py", "ops/dense_render.py", "bench.py",
)


def warn(msg: str) -> None:
    """A warning on stderr: the last stdout line stays the record."""
    print(f"WARNING: {msg}", file=sys.stderr, flush=True)


def peak_flops_for(kind: str) -> Optional[float]:
    for name, peak in PEAK_FLOPS_BY_KIND.items():
        if name in kind:
            return peak
    return None


def power_limit(device: torch.device) -> Optional[str]:
    """nvidia-smi's "name, power.limit" line of ``device``'s card; None on
    the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


# ------------------------------------------------------------------ #
# Timed paths
# ------------------------------------------------------------------ #

def run_e2e(ply, tj, mask_dir, settings, out_path, device) -> dict:
    """One full conversion, scene on disk to cloud on disk: what
    gs2pc_torch.cli.main runs, on one device (num_devices=1, the library's
    default, as the JAX package's), then the chunked PLY write.

    ``t_probe`` is 0.0: the port has no pair-budget probe.  ``blend`` and
    ``sampler`` say what ran, from the wrappers' launch counts: K1 ("cuda")
    or its twin ("torch"), K5 ("k5") or its twin ("torch").
    ``peak_device_bytes`` is the conversion's peak allocation on a card,
    None on the CPU."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    k1, k5 = blend_kernel.blend_tiles.launches, S.sample_points.launches
    log.reset_phases()
    t0 = time.perf_counter()
    conv = pipeline.convert_3dgs_to_pc(ply, tj, mask_dir, settings, device=device, num_devices=1)
    with log.phase("ply_write"):
        writer = save_point_cloud_ply(conv.cloud, out_path, chunk_size=10**6)
    t_total = time.perf_counter() - t0
    ph = dict(log.PHASE_SECONDS)
    return {
        "t_total": t_total,
        "t_load": ph.get("load_gaussians", 0.0),
        "t_parse": ph.get("scene_parse", 0.0),
        "t_upload": ph.get("scene_upload", 0.0),
        "t_probe": 0.0,
        "t_sweep": ph.get("render_sweep", 0.0),
        "t_sample": ph.get("point_sampling", 0.0),
        "t_io": ph.get("ply_write", 0.0),
        "n_points": int(conv.cloud.total),
        "diag": (conv.sweep_diag or [0.0, 0.0, 0.0, 0.0])[:4],
        "writer": writer,
        "blend": "cuda" if blend_kernel.blend_tiles.launches > k1 else "torch",
        "sampler": "k5" if S.sample_points.launches > k5 else "torch",
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
    }


def time_twin_sweep(arrays: capture.SceneArrays, n_cams, width, height, with_masks,
                    calc_surface, device) -> float:
    """Wall (s, synchronised) of one camera sweep of the bench's scene with
    K1's PyTorch twin in place of K1: render_sweep's loop through
    render_tile_camera's ``blend=`` seam, at the JAX stage's config (compact
    tables, run cap 4096).  No warm-up: the twin compiles nothing."""
    g = Gaussians.from_numpy(arrays.xyz, arrays.log_scales, arrays.rots, arrays.colours,
                             arrays.opacities, device=device)
    scene = scene_arrays(g)
    cameras, wp, hp = capture.make_cameras(n_cams, width, height, with_masks=with_masks,
                                           device=device)
    cfg = TileConfig(width_pad=wp, height_pad=hp, run_cap=4096, run_chunk=128, compact=True)
    sync(device)
    t0 = time.perf_counter()
    acc = init_accumulators(g.num_gaussians, device=device)
    for i in range(cameras.num_cameras):
        acc = update_accumulators(acc, render_tile_camera(
            *scene, cameras.at(i), cfg, calc_surface_distance=calc_surface,
            blend=blend_kernel.blend_tiles_torch))
    sync(device)
    return time.perf_counter() - t0


# ------------------------------------------------------------------ #
# The quality gate
# ------------------------------------------------------------------ #

def oracle_cache_path(n_gauss: int, width: int, height: int) -> Optional[str]:
    """Where the gate's oracle is cached: under GS2PC_CACHE_DIR when it is
    set (None when it is the empty string: no cache), else under the
    checkout's build/gs2pc_torch/."""
    root = os.environ.get("GS2PC_CACHE_DIR", BUILD_DIR)
    if not root:
        return None
    return os.path.join(root, f"bench_oracle_{capture.scene_kind()}_s{ORACLE_SEED}_"
                              f"{n_gauss}_{width}x{height}.npz")


def oracle_key(n_gauss: int, width: int, height: int) -> str:
    """What a cached oracle must have been rendered from: the scene (kind,
    seed, size), the camera, the bands and a hash of ORACLE_SOURCES."""
    h = hashlib.sha256()
    for rel in ORACLE_SOURCES:
        with open(os.path.join(PACKAGE_DIR, rel), "rb") as f:
            h.update(f.read())
    return (f"scene={capture.scene_kind()} seed={ORACLE_SEED} gaussians={n_gauss} "
            f"{width}x{height} band_pixels={BAND_PIXELS} src={h.hexdigest()[:16]}")


def load_oracle_cache(path: Optional[str], key: str, image_shape: tuple,
                      n_gauss: int) -> Optional[tuple]:
    """The cached (image rows, contrib, surf, bands done) at ``path`` when
    it was rendered from ``key`` and holds each array at its shape, else
    None (with a warning when a file is there).  Every array is read before
    any is used, so a cache that lacks one is rendered again from zero,
    never half loaded."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            got = {name: z[name] for name in ("key", "image", "contrib", "surf", "n_done")}
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        warn(f"oracle cache {path} is unreadable ({type(e).__name__}: {e}); rendering it again")
        return None
    if (str(got["key"]) != key or got["image"].shape != image_shape
            or got["contrib"].shape != (n_gauss,) or got["surf"].shape != (n_gauss,)):
        warn(f"oracle cache {path} is from another scene, camera or oracle source "
             f"({got['key']}); rendering it again")
        return None
    return got["image"], got["contrib"], got["surf"], int(got["n_done"])


def oracle_bands(width_pad: int, height_pad: int) -> tuple:
    """(rows a band, bands) of the oracle: whole pixel rows, at most
    BAND_PIXELS pixels a band and at most the image's rows (render_dense
    renders a band of min(pixel_chunk, image) pixels)."""
    rows = min(max(1, BAND_PIXELS // width_pad), height_pad)
    return rows, -(-(height_pad * width_pad) // (rows * width_pad))


def render_band(scene, cam, width_pad: int, height_pad: int, b: int) -> tuple:
    """Band ``b`` of the oracle, on the host: its image rows and its
    partial per-Gaussian contrib and surf_dist (render_dense with the
    surface pass and rect culling)."""
    rows, _ = oracle_bands(width_pad, height_pad)
    out = render_dense(*scene, cam, width_pad, height_pad, chunk=256,
                       pixel_chunk=rows * width_pad, calc_surface_distance=True,
                       rect_cull=True, block_range=(b, 1))
    return out.image.cpu().numpy(), out.contrib.cpu().numpy(), out.surf_dist.cpu().numpy()


def fold_bands(scene, cam, width_pad: int, height_pad: int, state: tuple,
               time_left: Optional[Callable[[], float]] = None) -> tuple:
    """Render the oracle's bands from the first that ``state`` = (image
    rows, contrib, surf, bands done) lacks, contrib folded by max and surf
    by min; returns the new state.  Stops before a band when
    ``time_left()`` is under the bands' mean time + 15 s (60 s + 15 s
    before the first)."""
    rows, n_blk = oracle_bands(width_pad, height_pad)
    img, contrib, surf, n_done = state
    t_band = None
    for b in range(n_done, n_blk):
        if time_left is not None and time_left() < (t_band or 60.0) + 15.0:
            break
        t0 = time.perf_counter()
        img_b, c_b, s_b = render_band(scene, cam, width_pad, height_pad, b)
        img[b * rows:(b + 1) * rows] = img_b
        contrib = np.maximum(contrib, c_b)
        surf = np.minimum(surf, s_b)
        dt = time.perf_counter() - t0
        t_band = dt if t_band is None else 0.5 * (t_band + dt)
        n_done = b + 1
    return img, contrib, surf, n_done


def psnr_vs_oracle(n_gauss: int, width: int, height: int, device,
                   time_left: Optional[Callable[[], float]] = None) -> dict:
    """The at-scale quality gate: the production tile renderer against the
    exact dense oracle on one unmasked camera of the capture scene of
    ``n_gauss`` Gaussians, seed 2 (compact rgb24 tables, run cap 4096,
    surface pass; TileConfig's surface_compact default, off).

    Returns {"psnr", "psnr_coverage", "complete"} and, with the whole
    oracle, the accumulator gates "acc_contrib_relerr",
    "acc_surf_underrun" and "acc_surf_bad_finite_frac".  The tile render
    needs 60 s of ``time_left()``; the oracle's bands stop under the
    deadline (fold_bands), and the bands done are cached (oracle_cache_path,
    written atomically; a failed write never fails the gate) for the next
    run to complete.  ``psnr_coverage`` is the share of image rows the
    oracle covers, and reads 1.0 only with the whole oracle."""
    pipeline.set_precision()  # TF32 would cost the tile render ~35 dB
    device = torch.device(device)
    scene = scene_arrays(capture_scene(n_gauss, ORACLE_SEED, device))
    cameras, wp, hp = capture.make_cameras(1, width, height, device=device)
    cam = cameras.at(0)
    cfg = TileConfig(width_pad=wp, height_pad=hp, run_cap=4096, run_chunk=128, compact=True)
    if time_left is not None and time_left() < 60.0:
        return {"psnr": None, "psnr_coverage": 0.0, "complete": False}

    tile = render_tile_camera(*scene, cam, cfg, calc_surface_distance=True)
    tile_img = tile.image.cpu().numpy()
    tile_contrib = tile.contrib.cpu().numpy()
    tile_surf = tile.surf_dist.cpu().numpy()

    rows_per_band, n_blk = oracle_bands(wp, hp)
    cache_path = oracle_cache_path(n_gauss, width, height)
    key = oracle_key(n_gauss, width, height)
    state = load_oracle_cache(cache_path, key, (n_blk * rows_per_band, wp, 3), n_gauss)
    if state is None:
        state = (np.zeros((n_blk * rows_per_band, wp, 3), np.float32),
                 np.zeros(n_gauss, np.float32), np.full(n_gauss, FLOAT_MAX_BENCH, np.float32), 0)
    n_before = state[3]
    oracle_rows, o_contrib, o_surf, n_done = fold_bands(scene, cam, wp, hp, state, time_left)
    if n_done > n_before and cache_path:
        try:
            save_npz_atomic(cache_path, image=oracle_rows, contrib=o_contrib, surf=o_surf,
                            n_done=np.array(n_done), key=np.array(key))
        except OSError as e:
            warn(f"oracle cache {cache_path} not written ({e})")

    complete = n_done >= n_blk
    h, w = int(height), int(width)
    rows_covered = min(n_done * rows_per_band, h)
    if rows_covered <= 0:
        return {"psnr": None, "psnr_coverage": 0.0, "complete": False}
    diff = tile_img[:rows_covered, :w] - oracle_rows[:rows_covered, :w]
    mse = float(np.mean(diff.astype(np.float64) ** 2))
    psnr = 99.0 if mse <= 0.0 else float(10.0 * math.log10(1.0 / mse))
    # Coverage reads 1.0 only with the whole oracle: the bands can cover
    # every image row before the last (padded) one is rendered, and a
    # rounded share could reach 1.0 early.
    coverage = 1.0 if complete else min(math.floor(1e4 * rows_covered / h) / 1e4, 0.9999)
    out = {"psnr": psnr, "psnr_coverage": coverage, "complete": complete}
    if not complete:
        # A partial oracle's accumulators are bounds (a max or a min over
        # fewer pixels): gating the tile's against them would false-fail.
        return out

    # The tile renderer sees a subset of the oracle's pairs (the circle
    # cull inside the rect, run-cap tails, the surface pass's early stop),
    # so equality is not the invariant.  These are:
    #  * contrib: near-equal in the production regime (max relative
    #    error, dead Gaussians floored at 0.05);
    #  * surface distance: a min over fewer pairs can only be larger, so a
    #    tile value below the oracle's by more than a depth-scaled
    #    tolerance (dropped sub-1/255 pairs shift the expected depth by up
    #    to ~0.4% of depth) is corruption;
    #  * finiteness: a Gaussian finite in the tile render and not in the
    #    oracle is impossible (subset).
    c_rel = float(np.max(
        np.abs(tile_contrib - o_contrib) / np.maximum(o_contrib, 0.05)
    )) if tile_contrib.size else 0.0
    fin_t = tile_surf < FLOAT_MAX_BENCH * 0.5
    fin_o = o_surf < FLOAT_MAX_BENCH * 0.5
    vm = cam.viewmatrix.cpu().numpy().astype(np.float64)
    means = scene.means.cpu().numpy().astype(np.float64)
    depth_g = (means @ vm[2, :3]) + vm[2, 3]
    tol = 1e-3 + 0.01 * np.abs(depth_g).astype(np.float32)
    both = fin_t & fin_o
    s_under = float(np.max(
        np.where(both, o_surf - tile_surf - tol, -np.inf)
    )) if both.any() else 0.0
    out.update({
        "acc_contrib_relerr": c_rel,
        "acc_surf_underrun": max(s_under, 0.0),
        "acc_surf_bad_finite_frac": float(np.mean(fin_t & ~fin_o)),
    })
    return out


def gate_fields(gate: dict) -> tuple:
    """(the record's fields of a psnr_vs_oracle result, whether the gate
    holds).  The whole oracle gives the accumulators and the verdict
    ``psnr_gate_pass``.  A partial one gives its PSNR and coverage, and a
    verdict only when its rows already fail: corruption can be local (the
    pair-dense central tiles), so rows that pass certify nothing."""
    rec = {}
    ok = True
    if gate.get("psnr") is not None:
        rec["psnr_vs_oracle"] = round(gate["psnr"], 2)
    rec["psnr_gate_db"] = PSNR_GATE_DB
    rec["psnr_oracle_coverage"] = gate.get("psnr_coverage", 0.0)
    if gate.get("complete"):
        rec["acc_contrib_relerr"] = round(gate["acc_contrib_relerr"], 5)
        rec["acc_surf_underrun"] = round(gate["acc_surf_underrun"], 5)
        rec["acc_surf_bad_finite_frac"] = round(gate["acc_surf_bad_finite_frac"], 6)
        ok = (gate["psnr"] >= PSNR_GATE_DB
              and gate["acc_contrib_relerr"] <= ACC_RELERR_GATE
              and gate["acc_surf_underrun"] <= 0.0
              and gate["acc_surf_bad_finite_frac"] <= 0.0)
        rec["psnr_gate_pass"] = ok
    elif gate.get("psnr") is not None and gate["psnr"] < PSNR_GATE_DB:
        ok = False
        rec["psnr_gate_pass"] = False
    return rec, ok


# ------------------------------------------------------------------ #
# The bench
# ------------------------------------------------------------------ #

def main() -> int:
    """Run the bench's stages under its deadline, printing the record after
    each; returns the exit code (1 when the gate fails)."""
    t_start = time.monotonic()
    deadline_s = float(os.environ.get("GS2PC_BENCH_DEADLINE_S", DEADLINE_S))

    def time_left() -> float:
        return deadline_s - (time.monotonic() - t_start)

    device = torch.device(os.environ.get("GS2PC_BENCH_DEVICE", "cuda:0"))
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("gs2pc_torch.bench: no CUDA device is available; the port runs on NVIDIA "
                 "GPUs (GS2PC_BENCH_DEVICE=cpu runs the kernels' PyTorch twins)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if os.environ.get("GS2PC_BENCH_PALLAS", "auto") != "auto":
        warn("GS2PC_BENCH_PALLAS tunes the TPU build only; it does nothing in gs2pc_torch")

    n_gauss = int(os.environ.get("GS2PC_BENCH_GAUSSIANS", 3_000_000))
    n_points = int(os.environ.get("GS2PC_BENCH_POINTS", 10_000_000))
    n_cams = int(os.environ.get("GS2PC_BENCH_CAMERAS", 45))
    width = int(os.environ.get("GS2PC_BENCH_WIDTH", 1280))
    height = int(os.environ.get("GS2PC_BENCH_HEIGHT", 720))
    calc_surface = os.environ.get("GS2PC_BENCH_SURFACE", "1") == "1"
    with_masks = os.environ.get("GS2PC_BENCH_MASKS", "1") == "1"
    compare = os.environ.get("GS2PC_BENCH_COMPARE", "0") == "1"
    want_psnr = os.environ.get("GS2PC_BENCH_PSNR", "1") == "1"
    n_psnr = int(os.environ.get("GS2PC_BENCH_PSNR_GAUSS", 1_000_000))
    bench_dir = os.environ.get("GS2PC_BENCH_DIR")

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    record = {
        "metric": (
            f"e2e_disk_to_disk_points_per_second[{n_gauss}g,{n_cams}cam@"
            f"{width}x{height},{n_points}pts,surface={int(calc_surface)},"
            f"masks={int(with_masks)}]"
        ),
        "unit": "points/s",
        "scene": capture.scene_kind(),
        "device": f"gpu:{kind}" if device.type == "cuda" else "cpu",
        "power_limit": power_limit(device),
    }

    def emit() -> None:
        record["bench_wall_s"] = round(time.monotonic() - t_start, 1)
        print(json.dumps(record), flush=True)

    def fill_from(run: dict) -> None:
        pps = run["n_points"] / run["t_total"]
        nd = run["diag"]
        # blend_mfu_est: the sweep's blend operations (pairs blended x 256
        # pixels x 30) over the sweep wall and the card's fp32 peak.
        peak = peak_flops_for(kind) if device.type == "cuda" else None
        mfu = (None if peak is None else
               round(nd[0] * TPX * FLOPS_PER_PAIR_PIXEL / max(run["t_sweep"], 1e-9) / peak, 5))
        record.update({
            "value": round(pps, 1),
            "vs_baseline": round(pps / NORTH_STAR_POINTS_PER_S, 3),
            "blend": run["blend"],
            "t_total_s": round(run["t_total"], 3),
            "t_load_s": round(run["t_load"], 3),
            "t_parse_s": round(run["t_parse"], 3),
            "t_upload_s": round(run["t_upload"], 3),
            "t_probe_s": round(run["t_probe"], 3),
            "t_sweep_s": round(run["t_sweep"], 3),
            "t_sample_s": round(run["t_sample"], 3),
            "t_io_s": round(run["t_io"], 3),
            "t_other_s": round(
                run["t_total"] - run["t_load"] - run["t_probe"]
                - run["t_sweep"] - run["t_sample"] - run["t_io"], 3,
            ),
            "points": run["n_points"],
            "pairs_blended": nd[0],
            "window_dropped": nd[1],
            "runcap_dropped": nd[2],
            "runcap_dropped_live": nd[3],
            "blend_mfu_est": mfu,
            "sampler": run["sampler"],
            "writer": run["writer"],
            "peak_device_bytes": run["peak_device_bytes"],
        })

    # The scene and its capture are made on the host and written to disk;
    # the conversions read them back as a user's would.
    scene = capture.make_scene_arrays(n_gauss)
    transforms, intr = capture.make_poses(n_cams, width, height)
    tmp = None
    if bench_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="gs2pc_torch_bench_")
        bench_dir = tmp.name
    try:
        os.makedirs(bench_dir, exist_ok=True)
        ply, tj, mask_dir = capture.write_capture(bench_dir, scene, transforms, intr, with_masks)
        out_path = os.path.join(bench_dir, "cloud.ply")
        # Surface distances on with a huge keep-std: the surface cull then
        # coincides with the visibility cull, so the workload stays the
        # north-star one while the surface pass runs on every camera.
        settings = GaussPointCloudSettings(
            num_points=n_points,
            surface_distance_std=1e6 if calc_surface else None,
            colour_resolution=width,
            quiet=True,
        )

        # Stage 1: the cold conversion (kernel builds included where build/
        # holds none).
        cold = run_e2e(ply, tj, mask_dir, settings, out_path, device)
        fill_from(cold)
        record["t_cold_s"] = round(cold["t_total"], 3)
        record["steady"] = False
        emit()

        # Stage 2: the steady conversion, the headline.
        if time_left() > 0.35 * cold["t_total"] + 20.0:
            fill_from(run_e2e(ply, tj, mask_dir, settings, out_path, device))
            record["steady"] = True
            emit()

        # Stage 3: the at-scale PSNR and accumulator gate.
        gate_ok = True
        if want_psnr and time_left() > 100.0:
            t0 = time.perf_counter()
            fields, gate_ok = gate_fields(
                psnr_vs_oracle(n_psnr, width, height, device, time_left=time_left))
            record.update(fields)
            record["t_gate_s"] = round(time.perf_counter() - t0, 3)
            emit()

        # Stage 4 (opt-in): the same sweep with K1's twin.
        if compare and time_left() > 120.0:
            record["torch_sweep_s"] = round(time_twin_sweep(
                scene, n_cams, width, height, with_masks, calc_surface, device), 3)
            emit()
    finally:
        if tmp is not None:
            tmp.cleanup()
    return 0 if gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
