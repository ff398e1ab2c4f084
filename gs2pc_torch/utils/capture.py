"""The synthetic capture the port's bench and chip smoke test convert: a
3DGS scene with capture statistics (or the legacy Gaussian ball), orbit
camera poses, vignette masks, the camera batch, and the on-disk files
(scene .ply, transforms.json, PNG masks) the CLI reads.

The port's copy of the capture helpers of the JAX package's ``bench.py``
(``make_ball_scene_arrays``, ``make_scene_arrays`` with its ``kind`` and
``GS2PC_BENCH_SCENE=capture|ball``, ``make_poses``, ``vignette_mask``,
``make_cameras``, ``write_scene_ply``, ``write_capture``): the same
arrays from the same seed, pinned by tests/test_torch_io_copies.py.  numpy
only, plus PIL for the masks and the port's camera module for the batch.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np


class SceneArrays(NamedTuple):
    """Host scene planes: xyz (P, 3), log_scales (P, 3), rots (P, 4) wxyz,
    colours (P, 3) in [0, 1], opacities (P,)."""

    xyz: np.ndarray
    log_scales: np.ndarray
    rots: np.ndarray
    colours: np.ndarray
    opacities: np.ndarray


SCENE_KINDS = ("capture", "ball")


def make_ball_scene_arrays(n, seed=0) -> SceneArrays:
    """The legacy bench scene: a dense Gaussian ball every camera fully sees.

    Pathological by capture standards: every camera's frustum contains all
    n Gaussians and per-tile depth runs saturate the per-tile cap, so it
    stresses the per-pair machinery ~3x harder than a MipNeRF360-style
    capture.  Selected by ``kind="ball"`` (GS2PC_BENCH_SCENE=ball) as a
    worst-case stress config."""
    r = np.random.default_rng(seed)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    xyz = r.normal(size=(n, 3)).astype(np.float32)
    xyz *= (1.0 + 2.0 * r.uniform(size=(n, 1)).astype(np.float32) ** 4)
    log_scales = r.uniform(-6.5, -4.0, (n, 3)).astype(np.float32)
    big = r.uniform(size=n) < 0.1
    log_scales[big] = r.uniform(-4.0, -2.5, (big.sum(), 3)).astype(np.float32)
    return SceneArrays(
        xyz, log_scales, quats,
        r.uniform(0, 1, (n, 3)).astype(np.float32),
        r.uniform(0.2, 1.0, n).astype(np.float32),
    )


def scene_kind(kind=None) -> str:
    """``kind``, or GS2PC_BENCH_SCENE (default "capture"); one of SCENE_KINDS."""
    kind = kind or os.environ.get("GS2PC_BENCH_SCENE", "capture")
    if kind not in SCENE_KINDS:
        raise ValueError(f"unknown scene kind {kind!r}; one of {SCENE_KINDS}")
    return kind


def make_scene_arrays(n, seed=0, kind=None) -> SceneArrays:
    """The bench scene of ``kind`` (scene_kind): by default the capture
    scene, capture statistics, not a worst-case ball.

    Models a trained MipNeRF360-style export the way the reference is
    actually run (README.md:104-109): splats concentrated on surfaces
    (ground annulus + central object clusters), a low-opacity filler
    shell, and a sparse far dome of large background splats.  Cameras
    orbiting the centre see a FRACTION of the scene per frustum and
    per-tile depth runs stay in the hundreds-to-low-thousands — matching
    real captures, where a 720p view of a 3M-splat scene expands to
    single-digit-millions of splat-tile pairs, not tens of millions."""
    if scene_kind(kind) == "ball":
        return make_ball_scene_arrays(n, seed)
    r = np.random.default_rng(seed)
    n_ground = int(n * 0.42)
    n_obj = int(n * 0.34)
    n_fill = int(n * 0.239)
    n_sky = n - n_ground - n_obj - n_fill  # ~0.1%

    # Ground: a disc of near-flat splats inside the camera ring, denser
    # towards the centre, scale growing with distance (trained exports
    # size splats to local observation density).
    rad = 0.4 + 3.8 * r.uniform(size=n_ground) ** 1.4
    ang = r.uniform(0, 2 * np.pi, n_ground)
    g_xyz = np.stack(
        [rad * np.cos(ang), -0.7 + 0.04 * r.normal(size=n_ground),
         rad * np.sin(ang)], axis=1,
    )
    g_s = r.uniform(-4.7, -3.9, n_ground) + 0.12 * rad
    g_scales = np.stack(
        [g_s, r.uniform(-5.4, -4.6, n_ground), g_s + r.uniform(-0.2, 0.2, n_ground)],
        axis=1,
    )

    # Objects: detail splats in clusters around the capture centre.
    n_clusters = 6
    centres = np.stack(
        [r.uniform(-1.2, 1.2, n_clusters),
         r.uniform(-0.4, 0.5, n_clusters),
         r.uniform(-1.2, 1.2, n_clusters)], axis=1,
    )
    which = r.integers(0, n_clusters, n_obj)
    # Trained exports reconstruct SURFACES: splats sit on object shells,
    # so a ray crosses a handful of near-opaque layers and the blend's
    # early stop fires after tens of pairs — volumetric blobs would give
    # every central tile a thousands-deep depth column no real capture
    # has.
    o_dir = r.normal(size=(n_obj, 3))
    o_dir /= np.linalg.norm(o_dir, axis=1, keepdims=True)
    o_rad = r.uniform(0.22, 0.45, n_obj) * (1.0 + 0.06 * r.normal(size=n_obj))
    o_xyz = centres[which] + o_dir * o_rad[:, None]
    o_scales = r.uniform(-5.0, -3.8, (n_obj, 3))

    # Filler: sparse low-opacity mid-scale splats in an outer shell
    # (beyond the camera ring, so they stay at moderate depth).
    f_rad = 9.0 + 5.0 * r.uniform(size=n_fill)
    f_dir = r.normal(size=(n_fill, 3))
    f_dir /= np.linalg.norm(f_dir, axis=1, keepdims=True)
    f_xyz = f_dir * f_rad[:, None]
    f_xyz[:, 1] = np.abs(f_xyz[:, 1]) * 0.5 - 0.5
    f_scales = r.uniform(-3.2, -2.2, (n_fill, 3))

    # Sky/background: few, huge, far — the 50+-tile splats every real
    # capture contains.
    s_dir = r.normal(size=(n_sky, 3))
    s_dir /= np.linalg.norm(s_dir, axis=1, keepdims=True)
    s_dir[:, 1] = np.abs(s_dir[:, 1])
    s_xyz = s_dir * 28.0
    s_scales = r.uniform(0.2, 1.1, (n_sky, 3))

    xyz = np.concatenate([g_xyz, o_xyz, f_xyz, s_xyz]).astype(np.float32)
    log_scales = np.concatenate(
        [g_scales, o_scales, f_scales, s_scales]
    ).astype(np.float32)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = np.concatenate(
        [r.uniform(0.6, 1.0, n_ground), r.uniform(0.5, 1.0, n_obj),
         r.uniform(0.05, 0.4, n_fill), r.uniform(0.5, 0.9, n_sky)]
    ).astype(np.float32)
    colours = r.uniform(0, 1, (n, 3)).astype(np.float32)
    return SceneArrays(xyz, log_scales, quats, colours, opac)


def make_poses(n_cams, width, height, focal_scale=0.9):
    """Orbit poses + intrinsics dicts (NeRF c2w convention)."""
    transforms, intr = {}, {}
    focal = focal_scale * width
    for i in range(n_cams):
        angle = i * (2 * np.pi / n_cams)
        c = np.array([5.0 * np.sin(angle), 1.5, -5.0 * np.cos(angle)])
        z = -c / np.linalg.norm(c)
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, c
        c2w[:, 1:3] = -c2w[:, 1:3]
        transforms[f"c{i:02d}"] = c2w.tolist()
        intr[f"c{i:02d}"] = (width, height, focal, focal)
    return transforms, intr


def vignette_mask(width, height):
    """Elliptical vignette (~86% live pixels), like a real masked capture."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    e = (
        ((xs - width / 2) / (width * 0.55)) ** 2
        + ((ys - height / 2) / (height * 0.55)) ** 2
    )
    return (e <= 1.0).astype(np.uint8)


def make_cameras(n_cams, width, height, focal_scale=0.9, with_masks=False, *, device):
    """The orbit cameras as a camera.CameraBatch on ``device``, with the
    vignette masks on request; returns (batch, padded width, padded
    height), as the JAX bench's make_cameras."""
    from gs2pc_torch.camera import build_camera_batch

    transforms, intr = make_poses(n_cams, width, height, focal_scale)
    masks = None
    if with_masks:
        m = vignette_mask(width, height)
        masks = {name: m for name in transforms}
    batch = build_camera_batch(transforms, intr, masks=masks, device=device)
    return batch, batch.width_pad, batch.height_pad


def write_scene_ply(path, scene):
    """Compact RGB-layout 3DGS .ply (read by gs2pc_torch.io.gaussians_io).

    Fields: xyz, red/green/blue (f32 in [0,1] — autodetect leaves them),
    opacity (logit; the loader sigmoids), scale_0..2 (log), rot_0..3."""
    xyz = np.asarray(scene.xyz, np.float32)
    n = xyz.shape[0]
    cols = np.asarray(scene.colours, np.float32)
    op = np.clip(np.asarray(scene.opacities, np.float32), 1e-6, 1 - 1e-6)
    logit = np.log(op / (1.0 - op)).astype(np.float32)
    props = (
        ["x", "y", "z", "red", "green", "blue", "opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    )
    rows = np.concatenate(
        [
            xyz, cols, logit[:, None],
            np.asarray(scene.log_scales, np.float32),
            np.asarray(scene.rots, np.float32),
        ],
        axis=1,
    ).astype("<f4")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(rows.tobytes())


def write_capture(root, scene, transforms, intr, with_masks):
    """Materialise scene.ply + transforms.json (+ PNG masks) on disk."""
    ply = os.path.join(root, "scene.ply")
    write_scene_ply(ply, scene)

    frames = []
    for name in sorted(transforms):
        w, h, fx, fy = intr[name]
        frames.append(
            {
                "file_path": f"images/{name}.png",
                "transform_matrix": transforms[name],
                "w": int(w), "h": int(h),
                "fl_x": float(fx), "fl_y": float(fy),
            }
        )
    tj = os.path.join(root, "transforms.json")
    with open(tj, "w") as fh:
        json.dump({"frames": frames}, fh)

    mask_dir = None
    if with_masks:
        from PIL import Image

        mask_dir = os.path.join(root, "masks")
        os.makedirs(mask_dir, exist_ok=True)
        w, h = intr[next(iter(intr))][:2]
        m = (vignette_mask(int(w), int(h)) * 255).astype(np.uint8)
        img = Image.fromarray(m, mode="L")
        for name in transforms:
            img.save(os.path.join(mask_dir, f"{name}.png"))
    return ply, tj, mask_dir
