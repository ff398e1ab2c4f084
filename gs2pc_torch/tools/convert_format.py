"""Convert Gaussian scenes between .ply and .splat (counterpart of
tools/convert_format.py, host numpy only; the output bytes are the JAX
tool's):

    python -m gs2pc_torch.tools.convert_format scene.ply scene.splat
    python -m gs2pc_torch.tools.convert_format scene.splat scene.ply

.splat stores linear scales and u8 colours and rotations; .ply -> .splat
keeps the degree-0 colour only (the format has no SH fields), and .splat ->
.ply writes the Gaussian-scene PLY with RGB colours, logit opacities, log
scales and rotations.  ``main(argv)`` returns the number of Gaussians.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from gs2pc_torch.io.gaussians_io import load_ply_gaussians
from gs2pc_torch.io.splat import load_splat_gaussians, save_splat


def load_host(path: str, max_sh_degree: int = 3):
    """(xyz, log_scales, rots, colours, opacities) of a .ply or .splat as
    float32 host arrays, as the JAX loader puts them on its device."""
    ext = os.path.splitext(path)[1]
    if ext == ".splat":
        arrays = load_splat_gaussians(path)
    elif ext == ".ply":
        arrays = load_ply_gaussians(path, max_sh_degree=max_sh_degree, with_shs=False)
    else:
        raise ValueError(f"Unsupported input type {ext}")
    xyz, log_scales, rots, colours, opacities = (np.asarray(a, np.float32) for a in arrays[:5])
    return xyz, log_scales, rots, colours, opacities.reshape(-1)


def save_scene_ply(path: str, xyz, log_scales, rots, colours, opacities) -> None:
    """Gaussian-scene PLY with RGB colours (no SH round-trip from .splat)."""
    n = xyz.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float opacity\n"
        + "".join(f"property float scale_{i}\n" for i in range(3))
        + "".join(f"property float rot_{i}\n" for i in range(4))
        + "end_header\n"
    )
    dtype = (
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
         ("red", "u1"), ("green", "u1"), ("blue", "u1"),
         ("opacity", "<f4")]
        + [(f"scale_{i}", "<f4") for i in range(3)]
        + [(f"rot_{i}", "<f4") for i in range(4)]
    )
    rec = np.zeros(n, dtype)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = np.clip(colours * 255, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
    # Raw (pre-sigmoid) opacity, as exporters store it.
    op = np.clip(opacities, 1e-6, 1 - 1e-6)
    rec["opacity"] = np.log(op / (1 - op))
    for i in range(3):
        rec[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        rec[f"rot_{i}"] = rots[:, i]
    with open(path, "wb") as fh:
        fh.write(header.encode())
        fh.write(rec.tobytes())


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--max_sh_degree", type=int, default=3)
    args = ap.parse_args(argv)

    src_ext = os.path.splitext(args.src)[1]
    dst_ext = os.path.splitext(args.dst)[1]
    if dst_ext not in (".splat", ".ply"):
        raise SystemExit(f"Unsupported destination type {dst_ext}")
    xyz, log_scales, rots, colours, opacities = load_host(args.src, args.max_sh_degree)
    if dst_ext == ".splat":
        save_splat(args.dst, xyz, log_scales, rots, colours, opacities)
    else:
        save_scene_ply(args.dst, xyz, log_scales, rots, colours, opacities)
    n = xyz.shape[0]
    print(f"{args.src} ({src_ext}) -> {args.dst} ({dst_ext}): {n} gaussians", flush=True)
    return n


if __name__ == "__main__":
    main()
