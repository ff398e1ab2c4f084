""".splat binary loader (parity: gauss_dataloader.py:84-115) and writer;
the port's copy of gs2pc.io.splat.

Packed record layout: xyz f32x3 | scales f32x3 | rgba u8x4 | rot u8x4.
"""

from __future__ import annotations

import numpy as np

SPLAT_DTYPE = np.dtype(
    [
        ("xyz", np.float32, 3),
        ("scales", np.float32, 3),
        ("colour", np.uint8, 4),
        ("rots", np.uint8, 4),
    ]
)


def load_splat_gaussians(path: str):
    """Returns (xyz, log_scales, rots, colours, opacities, shs=None)."""
    with open(path, "rb") as fh:
        content = fh.read()

    count = len(content) // SPLAT_DTYPE.itemsize
    data = np.frombuffer(content, dtype=SPLAT_DTYPE, count=count)

    xyz = np.ascontiguousarray(data["xyz"]).astype(np.float32)
    # scales stored linear in .splat; pipeline keeps log-space
    log_scales = np.log(np.maximum(data["scales"], 1e-30)).astype(np.float32)
    colours = (data["colour"][:, :3] / 255.0).astype(np.float32)
    opacities = (data["colour"][:, 3] / 255.0).astype(np.float32)
    rots = ((data["rots"].astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    norm = np.maximum(np.linalg.norm(rots, axis=1, keepdims=True), 1e-12)
    rots = rots / norm
    return xyz, log_scales, rots, colours, opacities, None



def save_splat(path: str, xyz, log_scales, rots, colours, opacities) -> None:
    """Write a .splat file (inverse of load; handy for tests and export)."""
    n = len(xyz)
    out = np.zeros(n, dtype=SPLAT_DTYPE)
    out["xyz"] = np.asarray(xyz, np.float32)
    out["scales"] = np.exp(np.asarray(log_scales, np.float32))
    rgba = np.zeros((n, 4), np.uint8)
    rgba[:, :3] = np.clip(np.asarray(colours) * 255.0, 0, 255).astype(np.uint8)
    rgba[:, 3] = np.clip(np.asarray(opacities) * 255.0, 0, 255).astype(np.uint8)
    out["colour"] = rgba
    q = np.asarray(rots, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    out["rots"] = np.clip(np.round(q * 128.0 + 128.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(out.tobytes())
