"""Scene loading to one device (counterpart of gs2pc.io.gaussians_io).

The .ply codec and the .splat loader are the port's copies of the JAX
package's (gs2pc_torch.io.ply.read_ply, gs2pc_torch.io.splat); the column
extraction below repeats gs2pc.io.ply.load_ply_gaussians' rules.  As in
the JAX package, each plane of a .ply scene is handed to the upload the
moment the parser has it (``plane_hook``), so on a card its transfer runs
while the remaining columns are extracted.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gs2pc_torch.io.ply import read_ply
from gs2pc_torch.io.splat import load_splat_gaussians
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.utils import log

SH_C0 = 0.28209479177387814


def _sorted_props(names, prefix):
    return sorted(
        (p for p in names if p.startswith(prefix)), key=lambda x: int(x.split("_")[-1])
    )


def load_ply_gaussians(path: str, max_sh_degree: int = 3, plane_hook=None):
    """3DGS .ply -> host arrays (xyz, log_scales, rots, colours, opacities,
    shs), with the same rules as gs2pc.io.ply.load_ply_gaussians: sigmoid
    opacities, degree-0 SH colours (or RGB with /255 autodetect), unit
    quaternions sign-normalised to w >= 0, and the full SH coefficients
    (P, 3, (max_sh_degree + 1)^2) of an SH scene (None for RGB colours):
    f_dc first, then the f_rest_j sorted by their number, channel-major.

    ``plane_hook(name, array)`` is called the moment each plane is final,
    in the JAX package's order and with its names: xyz, opacities, colours
    (then shs, for an SH scene), log_scales, rots.

    Spans (utils.log.span): ``ply_read`` the file read into records,
    ``ply_sh_rest`` the f_rest_* stack into ``shs``, ``ply_columns`` every
    other plane and the hook calls; the three do not overlap."""
    hook = plane_hook or (lambda name, array: None)
    with log.span("ply_read"):
        vertex = next(iter(read_ply(path).values()))
    names = vertex.property_names
    props = set(names)
    with log.span("ply_columns"):
        xyz = np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=1).astype(np.float32)
        n = xyz.shape[0]
        hook("xyz", xyz)

        if "opacity" in props:
            raw = np.asarray(vertex["opacity"], np.float32).reshape(-1)
            opacities = 1.0 / (1.0 + np.exp(-raw))
        else:
            opacities = np.ones(n, np.float32)
        hook("opacities", opacities)

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

    shs = None
    if "f_dc_0" in props:
        with log.span("ply_sh_rest"):
            if rest:
                f_rest = np.stack([vertex[p] for p in rest], axis=1).astype(np.float32)
                f_rest = f_rest.reshape(n, 3, (max_sh_degree + 1) ** 2 - 1)
                shs = np.concatenate([f_dc[:, :, None], f_rest], axis=2)
            else:
                shs = f_dc[:, :, None]

    with log.span("ply_columns"):
        hook("colours", colours)
        if shs is not None:
            hook("shs", shs)

        scale_names = _sorted_props(names, "scale_")
        if scale_names:
            log_scales = np.stack([vertex[p] for p in scale_names], axis=1).astype(np.float32)
        else:
            log_scales = np.full((n, 3), -8.0, np.float32)
        hook("log_scales", log_scales)

        rot_names = _sorted_props(names, "rot")
        if rot_names:
            rots = np.stack([vertex[p] for p in rot_names], axis=1).astype(np.float32)
            rots = rots / np.maximum(np.linalg.norm(rots, axis=1, keepdims=True), 1e-12)
            rots = np.where(rots[:, :1] < 0.0, -rots, rots)
        else:
            rots = np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
        hook("rots", rots)
    return xyz, log_scales, rots, colours, opacities, shs


def quantise_colours_u8(colours: np.ndarray) -> np.ndarray:
    """Round-to-nearest 8-bit colours, returned as float32 k * (1/255) (the
    value the compact blend table decodes, and the JAX loader's): the exact
    quantisation the compact blend table applies (rasterize.pack_blend_table)."""
    c8 = np.round(np.clip(colours.astype(np.float32), 0.0, 1.0) * np.float32(255.0))
    return c8.astype(np.uint8).astype(np.float32) * np.float32(1.0 / 255.0)


class PlaneUpload:
    """The scene's planes on ``device`` as the parser hands them over (a
    ``plane_hook``): colours quantised with ``compact_colours``, the SH
    coefficients kept only ``with_shs``.

    On a card one worker thread takes each plane in turn while the parse
    goes on: it quantises the colours, copies the plane into pinned host
    memory and starts its upload with ``non_blocking=True`` on a side
    stream (the JAX loader uploads from a pool of threads, for the same
    reason: numpy and the copies release the interpreter lock, so this work
    hides under the column extraction).  ``scene()`` waits for the worker,
    makes the current stream wait for the uploads and returns the scene.
    The pinned sources are kept until then (and torch's host allocator
    reuses none of their blocks before its copy has finished).  On the CPU
    a plane becomes a tensor at once, as Gaussians.from_numpy makes it.
    The span ``plane_upload`` sums the host seconds of every plane's hand-off
    (quantise, pinned copy, enqueue), on the worker or inline."""

    def __init__(self, device, compact_colours: bool = False, with_shs: bool = False):
        self.device = torch.device(device)
        self.compact_colours = compact_colours
        self.with_shs = with_shs
        self.planes: dict = {}
        self._pinned: list = []
        self._pending: list = []
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="gs2pc_upload")

    def __call__(self, name: str, array: np.ndarray) -> None:
        if name == "shs" and not self.with_shs:
            return
        if self._pool is None:
            self._put(name, array)
        else:
            self._pending.append(self._pool.submit(self._put, name, array))

    def _put(self, name: str, array: np.ndarray) -> None:
        with log.span("plane_upload"):
            if name == "colours" and self.compact_colours:
                array = quantise_colours_u8(array)
            host = np.require(array, np.float32, ["C", "W"])
            if self._stream is None:
                self.planes[name] = torch.as_tensor(host, device=self.device)
                return
            pinned = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
            pinned.numpy()[...] = host
            self._pinned.append(pinned)
            with torch.cuda.stream(self._stream):
                self.planes[name] = pinned.to(self.device, non_blocking=True)

    def close(self) -> None:
        """Wait for the worker and stop it (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def scene(self) -> Gaussians:
        """The planes as a Gaussians with every row kept, usable on the
        current stream; raises what a plane's upload raised."""
        self.close()
        for done in self._pending:
            done.result()
        p = self.planes
        if self._stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self._stream)
            for t in p.values():
                t.record_stream(current)
            self._pinned.clear()
        return Gaussians(
            xyz=p["xyz"], log_scales=p["log_scales"], rots=p["rots"],
            opacities=p["opacities"].reshape(-1), colours=p["colours"], shs=p.get("shs"),
            normals=None,
            keep_mask=torch.ones(p["xyz"].shape[0], dtype=torch.bool, device=self.device),
        )


def load_gaussians(
    input_path: str, max_sh_degree: int = 3, compact_colours: bool = False,
    with_shs: bool = False, *, device
) -> Gaussians:
    """Load a .ply or .splat scene onto ``device``.

    With ``compact_colours`` the colour plane is quantised to 8 bits per
    channel before the upload, as in the JAX loader.  The SH coefficients
    of an SH scene are uploaded only ``with_shs`` (--sh_colour_eval): a
    degree-3 scene of 3M Gaussians carries 576 MB of them.  A .ply scene's
    planes start their upload while the parse goes on (PlaneUpload); a
    .splat scene's, which its parser makes together, after it."""
    ext = os.path.splitext(input_path)[1]
    if ext not in (".splat", ".ply"):
        raise ValueError(f"Unsupported input type {ext}")
    upload = PlaneUpload(device, compact_colours=compact_colours, with_shs=with_shs)
    try:
        with log.phase("scene_parse"):
            if ext == ".splat":
                xyz, log_scales, rots, colours, opacities, _ = load_splat_gaussians(input_path)
                for name, plane in (("xyz", xyz), ("opacities", opacities),
                                    ("colours", colours), ("log_scales", log_scales),
                                    ("rots", rots)):
                    upload(name, plane)
            else:
                load_ply_gaussians(input_path, max_sh_degree=max_sh_degree, plane_hook=upload)
        with log.phase("scene_upload"):
            return upload.scene()
    finally:
        upload.close()
