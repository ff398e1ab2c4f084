"""The benchmark's input: a trained 3D Gaussian Splatting capture, written
as the INRIA trainer exports it, and its camera poses.

There is no network, so no published scene can be read.  The scene is made
from the run's seed with the statistics of a Mip-NeRF 360 capture: splats
on surfaces (a ground disc and shells around object clusters), a
low-opacity filler shell and a sparse far dome of large splats.  This is a
frozen copy of the "capture" kind of the port's synthetic scene
(gs2pc_torch/utils/capture.py, make_scene_arrays), drawn with torch on the
device in a few large calls instead of numpy on the host, so the values
differ from that generator's while the statistics are its own.  The content
is the same in every run; the run's seed orders the Gaussians in the file.

The export has the INRIA layout: 62 float32 properties a Gaussian (x y z,
nx ny nz, f_dc_0-2, f_rest_0-44, opacity, scale_0-2, rot_0-3), 248 bytes
each.  f_dc carries the colour; f_rest is drawn ~N(0, 0.02), as the
repository's SH fixture draws it.  The poses are an orbit of the published
image count at the training resolution, in a NeRF transforms.json.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

SH_C0 = 0.28209479177387814
F_REST_STD = 0.02
ORBIT_RADIUS = 5.0
ORBIT_HEIGHT = 1.5
# The seed of the scene's content (the run's seed orders the Gaussians).
CONTENT_SEED = 20221


def export_properties(sh_degree: int = 3) -> list:
    """The INRIA export's float properties, in file order."""
    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    return (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
            + [f"f_rest_{i}" for i in range(n_rest)]
            + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"])


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def make_scene(n: int, gen: torch.Generator, device) -> dict:
    """Scene planes of ``n`` Gaussians on ``device``: xyz (n, 3), log_scales
    (n, 3), rots (n, 4) unit wxyz, colours (n, 3) in [0, 1], opacities (n,)."""
    u = lambda shape, lo, hi: _uniform(gen, shape, lo, hi, device)  # noqa: E731
    nrm = lambda shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    n_ground, n_obj, n_fill = int(n * 0.42), int(n * 0.34), int(n * 0.239)
    n_sky = n - n_ground - n_obj - n_fill

    # Ground: a disc of near-flat splats inside the camera ring, denser
    # towards the centre, larger with distance.
    rad = 0.4 + 3.8 * torch.rand(n_ground, generator=gen, device=device) ** 1.4
    ang = u(n_ground, 0.0, 2 * math.pi)
    g_xyz = torch.stack([rad * torch.cos(ang), -0.7 + 0.04 * nrm(n_ground),
                         rad * torch.sin(ang)], dim=1)
    g_s = u(n_ground, -4.7, -3.9) + 0.12 * rad
    g_scales = torch.stack([g_s, u(n_ground, -5.4, -4.6), g_s + u(n_ground, -0.2, 0.2)], dim=1)

    # Objects: splats on the shells of six clusters around the centre.
    centres = torch.stack([u(6, -1.2, 1.2), u(6, -0.4, 0.5), u(6, -1.2, 1.2)], dim=1)
    which = torch.randint(0, 6, (n_obj,), generator=gen, device=device)
    o_rad = u(n_obj, 0.22, 0.45) * (1.0 + 0.06 * nrm(n_obj))
    o_xyz = centres[which] + _unit(nrm((n_obj, 3))) * o_rad[:, None]
    o_scales = u((n_obj, 3), -5.0, -3.8)

    # Filler: low-opacity mid-scale splats in a shell beyond the ring.
    f_xyz = _unit(nrm((n_fill, 3))) * (9.0 + 5.0 * torch.rand(n_fill, generator=gen,
                                                                device=device))[:, None]
    f_xyz[:, 1] = f_xyz[:, 1].abs() * 0.5 - 0.5
    f_scales = u((n_fill, 3), -3.2, -2.2)

    # Background: few, huge, far splats on an upper dome.
    s_dir = _unit(nrm((n_sky, 3)))
    s_dir[:, 1] = s_dir[:, 1].abs()
    s_xyz = s_dir * 28.0
    s_scales = u((n_sky, 3), 0.2, 1.1)

    opac = torch.cat([u(n_ground, 0.6, 1.0), u(n_obj, 0.5, 1.0), u(n_fill, 0.05, 0.4),
                      u(n_sky, 0.5, 0.9)])
    return dict(
        xyz=torch.cat([g_xyz, o_xyz, f_xyz, s_xyz]),
        log_scales=torch.cat([g_scales, o_scales, f_scales, s_scales]),
        rots=_unit(nrm((n, 4))),
        colours=torch.rand((n, 3), generator=gen, device=device),
        opacities=opac,
    )


def export_rows(scene: dict, sh_degree: int, gen: torch.Generator) -> torch.Tensor:
    """(n, 62) float32 rows of the INRIA export of ``scene``: zero normals,
    f_dc from the colours, f_rest ~N(0, F_REST_STD), logit opacities, log
    scales and the wxyz quaternion."""
    xyz = scene["xyz"]
    n, dev = xyz.shape[0], xyz.device
    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    op = scene["opacities"].clamp(1e-6, 1.0 - 1e-6)
    return torch.cat([
        xyz, torch.zeros((n, 3), device=dev), (scene["colours"] - 0.5) / SH_C0,
        F_REST_STD * torch.randn((n, n_rest), generator=gen, device=dev),
        torch.log(op / (1.0 - op))[:, None], scene["log_scales"], scene["rots"],
    ], dim=1).to(torch.float32).contiguous()


def write_export(path: str, rows: torch.Tensor, sh_degree: int) -> int:
    """Write ``rows`` as a binary little-endian PLY with the export's
    properties; returns the bytes written."""
    names = export_properties(sh_degree)
    if rows.shape[1] != len(names):
        raise ValueError(f"{rows.shape[1]} columns for {len(names)} properties")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {rows.shape[0]}\n"
              + "".join(f"property float {p}\n" for p in names) + "end_header\n").encode()
    body = rows.cpu().numpy().astype("<f4", copy=False)
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(memoryview(body).cast("B"))
        # On disk before the window, as a trained scene is: its write-back
        # would otherwise run under the first conversions.
        fh.flush()
        os.fsync(fh.fileno())
    return len(header) + body.nbytes


def orbit_frames(n_images: int, width: int, height: int, focal: float) -> list:
    """``n_images`` NeRF-convention camera-to-world poses on a ring around
    the scene's centre, looking at it, each with its intrinsics."""
    frames = []
    for i in range(n_images):
        a = i * (2 * math.pi / n_images)
        c = np.array([ORBIT_RADIUS * math.sin(a), ORBIT_HEIGHT, -ORBIT_RADIUS * math.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, c
        c2w[:, 1:3] = -c2w[:, 1:3]
        frames.append({"file_path": f"images/frame_{i:04d}.png",
                       "transform_matrix": c2w.tolist(), "w": int(width), "h": int(height),
                       "fl_x": float(focal), "fl_y": float(focal)})
    return frames


def write_capture(root: str, config: dict, seed: int, device) -> dict:
    """Make the configuration's scene on ``device`` and write ``root``/
    scene.ply and ``root``/transforms.json; returns their paths and the
    bytes written.  The scene's content is drawn from CONTENT_SEED and
    ``seed`` orders its Gaussians, so every seed gives the conversion the
    same work in another order; the same seed gives the same files."""
    gen = torch.Generator(device=device)
    gen.manual_seed(CONTENT_SEED)
    n = int(config["gaussians"])
    scene = make_scene(n, gen, device)
    rows = export_rows(scene, int(config["sh_degree"]), gen)
    del scene
    gen.manual_seed(int(seed))
    rows = rows[torch.randperm(n, generator=gen, device=device)]
    os.makedirs(root, exist_ok=True)
    ply = os.path.join(root, "scene.ply")
    n_bytes = write_export(ply, rows, int(config["sh_degree"]))
    del rows
    frames = orbit_frames(int(config["images"]), int(config["width"]), int(config["height"]),
                          float(config["focal_scale"]) * int(config["width"]))
    tj = os.path.join(root, "transforms.json")
    with open(tj, "w") as fh:
        json.dump({"frames": frames}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    return {"scene": ply, "transforms": tj, "bytes": n_bytes}
