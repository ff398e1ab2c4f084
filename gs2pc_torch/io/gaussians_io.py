"""Scene loading to one device (counterpart of gs2pc.io.gaussians_io).

The .ply codec and the .splat loader are the port's copies of the JAX
package's (gs2pc_torch.io.ply.read_ply, gs2pc_torch.io.splat); the column
extraction below repeats gs2pc.io.ply.load_ply_gaussians' rules.
"""

from __future__ import annotations

import os

import numpy as np

from gs2pc_torch.io.ply import read_ply
from gs2pc_torch.io.splat import load_splat_gaussians
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.utils import log

SH_C0 = 0.28209479177387814


def _sorted_props(names, prefix):
    return sorted(
        (p for p in names if p.startswith(prefix)), key=lambda x: int(x.split("_")[-1])
    )


def load_ply_gaussians(path: str, max_sh_degree: int = 3):
    """3DGS .ply -> host arrays (xyz, log_scales, rots, colours, opacities,
    shs), with the same rules as gs2pc.io.ply.load_ply_gaussians: sigmoid
    opacities, degree-0 SH colours (or RGB with /255 autodetect), unit
    quaternions sign-normalised to w >= 0, and the full SH coefficients
    (P, 3, (max_sh_degree + 1)^2) of an SH scene (None for RGB colours):
    f_dc first, then the f_rest_j sorted by their number, channel-major."""
    vertex = next(iter(read_ply(path).values()))
    names = vertex.property_names
    props = set(names)
    xyz = np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=1).astype(np.float32)
    n = xyz.shape[0]

    if "opacity" in props:
        raw = np.asarray(vertex["opacity"], np.float32).reshape(-1)
        opacities = 1.0 / (1.0 + np.exp(-raw))
    else:
        opacities = np.ones(n, np.float32)

    shs = None
    if "f_dc_0" in props:
        f_dc = np.stack(
            [vertex["f_dc_0"], vertex["f_dc_1"], vertex["f_dc_2"]], axis=1
        ).astype(np.float32)
        rest = _sorted_props(names, "f_rest_")
        expected = 3 * (max_sh_degree + 1) ** 2 - 3
        if len(rest) != expected:
            raise ValueError(
                f"Expected {expected} f_rest_* properties for sh degree "
                f"{max_sh_degree}, found {len(rest)}"
            )
        if rest:
            f_rest = np.stack([vertex[p] for p in rest], axis=1).astype(np.float32)
            f_rest = f_rest.reshape(n, 3, (max_sh_degree + 1) ** 2 - 1)
            shs = np.concatenate([f_dc[:, :, None], f_rest], axis=2)
        else:
            shs = f_dc[:, :, None]
        colours = np.clip(SH_C0 * f_dc + 0.5, 0.0, 1.0).astype(np.float32)
    elif "red" in props:
        colours = np.stack(
            [vertex["red"], vertex["green"], vertex["blue"]], axis=1
        ).astype(np.float32)
        if (colours > 1.0).any():
            colours = np.clip(colours / 255.0, 0.0, 1.0)
    else:
        raise ValueError(
            "Input ply file does not have valid colours (must have either "
            "spherical harmonics or RGB colour fields)"
        )

    scale_names = _sorted_props(names, "scale_")
    if scale_names:
        log_scales = np.stack([vertex[p] for p in scale_names], axis=1).astype(np.float32)
    else:
        log_scales = np.full((n, 3), -8.0, np.float32)

    rot_names = _sorted_props(names, "rot")
    if rot_names:
        rots = np.stack([vertex[p] for p in rot_names], axis=1).astype(np.float32)
        rots = rots / np.maximum(np.linalg.norm(rots, axis=1, keepdims=True), 1e-12)
        rots = np.where(rots[:, :1] < 0.0, -rots, rots)
    else:
        rots = np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
    return xyz, log_scales, rots, colours, opacities, shs


def quantise_colours_u8(colours: np.ndarray) -> np.ndarray:
    """Round-to-nearest 8-bit colours, returned as float32 k * (1/255) (the
    value the compact blend table decodes, and the JAX loader's): the exact
    quantisation the compact blend table applies (rasterize.pack_blend_table)."""
    c8 = np.round(np.clip(colours.astype(np.float32), 0.0, 1.0) * np.float32(255.0))
    return c8.astype(np.uint8).astype(np.float32) * np.float32(1.0 / 255.0)


def load_gaussians(
    input_path: str, max_sh_degree: int = 3, compact_colours: bool = False,
    with_shs: bool = False, *, device
) -> Gaussians:
    """Load a .ply or .splat scene onto ``device``.

    With ``compact_colours`` the colour plane is quantised to 8 bits per
    channel before the upload, as in the JAX loader.  The SH coefficients
    of an SH scene are uploaded only ``with_shs`` (--sh_colour_eval): a
    degree-3 scene of 3M Gaussians carries 576 MB of them."""
    ext = os.path.splitext(input_path)[1]
    with log.phase("scene_parse"):
        if ext == ".splat":
            arrays = load_splat_gaussians(input_path)  # its SH slot is None
        elif ext == ".ply":
            arrays = load_ply_gaussians(input_path, max_sh_degree=max_sh_degree)
        else:
            raise ValueError(f"Unsupported input type {ext}")
    xyz, log_scales, rots, colours, opacities, shs = arrays
    if compact_colours:
        colours = quantise_colours_u8(colours)
    with log.phase("scene_upload"):
        return Gaussians.from_numpy(xyz, log_scales, rots, colours, opacities,
                                    shs=shs if with_shs else None, device=device)
