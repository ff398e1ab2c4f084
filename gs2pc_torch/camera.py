"""Camera batch construction (counterpart of gs2pc.camera).

One convention, as in the JAX package: input c2w is NeRF-convention, the
rotation's columns 1:2 are negated (OpenGL -> OpenCV), V = inv(c2w_cv),
x_ndc = (x_v / z_v) / tanfovx and ndc2Pix(v, S) = ((v + 1) S - 1) / 2.

Masks stay one uint8 per pixel on the device (the JAX package bit-packs
them for its slow host link).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

ZNEAR = 10.0
ZFAR = 100.0


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """OpenGL-style projection, column-vector form."""
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / math.tan(fovx / 2)
    P[1, 1] = 1.0 / math.tan(fovy / 2)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def make_camera(
    c2w_nerf: np.ndarray,
    intrinsic: Sequence,
    colour_resolution: Optional[int] = None,
    mask: Optional[np.ndarray] = None,
) -> dict:
    """Host arrays of one camera.  ``colour_resolution`` rescales the render
    width, except when a mask is given: a mask disables the rescale."""
    native_w = int(intrinsic[0])
    native_h = int(intrinsic[1])
    diff = 1.0 if (colour_resolution is None or mask is not None) else (
        colour_resolution / native_w
    )
    if mask is not None and (mask.shape[1] != native_w or mask.shape[0] != native_h):
        raise ValueError("Size of mask must match size of input image")

    img_w = int(native_w * diff)
    img_h = int(native_h * diff)
    focal_x = float(intrinsic[2]) * diff
    focal_y = float(intrinsic[3]) * diff

    c2w = np.asarray(c2w_nerf, np.float64).copy()
    c2w[:, 1:3] = -c2w[:, 1:3]
    fovx = focal2fov(focal_x, img_w)
    fovy = focal2fov(focal_y, img_h)
    view = np.linalg.inv(c2w)
    full = get_projection_matrix(ZNEAR, ZFAR, fovx, fovy) @ view
    return dict(
        viewmatrix=view.astype(np.float32),
        projmatrix=full.astype(np.float32),
        campos=c2w[:3, 3].astype(np.float32),
        tanfovx=np.float32(math.tan(fovx * 0.5)),
        tanfovy=np.float32(math.tan(fovy * 0.5)),
        focal_x=np.float32(img_w / (2 * math.tan(fovx * 0.5))),
        focal_y=np.float32(img_h / (2 * math.tan(fovy * 0.5))),
        width=np.int32(img_w),
        height=np.int32(img_h),
        mask=mask,
    )


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera of a batch: 0-d float32 tensors for the intrinsics (so the
    projection arithmetic stays float32, as in JAX), Python ints for the
    true image size, and the (Hp * Wp,) uint8 mask or None."""

    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    focal_x: torch.Tensor
    focal_y: torch.Tensor
    width: int
    height: int
    mask: Optional[torch.Tensor]

    def to(self, device) -> "Camera":
        """This camera's tensors on ``device`` (no copy where they already are)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device)
            for f in CAMERA_TENSORS if getattr(self, f) is not None
        })


# The tensor fields of Camera and CameraBatch.
CAMERA_TENSORS = (
    "viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy", "focal_x", "focal_y", "mask",
)


@dataclasses.dataclass(frozen=True)
class CameraBatch:
    """N cameras with shared padded render dims ``width_pad`` x ``height_pad``."""

    viewmatrix: torch.Tensor  # (N, 4, 4) world->view
    projmatrix: torch.Tensor  # (N, 4, 4) P @ V
    campos: torch.Tensor  # (N, 3)
    tanfovx: torch.Tensor  # (N,)
    tanfovy: torch.Tensor
    focal_x: torch.Tensor
    focal_y: torch.Tensor
    widths: tuple  # N true widths (host ints)
    heights: tuple
    mask: Optional[torch.Tensor]  # (N, Hp * Wp) uint8 0/1, or None
    width_pad: int
    height_pad: int

    @property
    def num_cameras(self) -> int:
        return self.viewmatrix.shape[0]

    def at(self, i: int) -> Camera:
        return Camera(
            viewmatrix=self.viewmatrix[i],
            projmatrix=self.projmatrix[i],
            campos=self.campos[i],
            tanfovx=self.tanfovx[i],
            tanfovy=self.tanfovy[i],
            focal_x=self.focal_x[i],
            focal_y=self.focal_y[i],
            width=int(self.widths[i]),
            height=int(self.heights[i]),
            mask=None if self.mask is None else self.mask[i],
        )

    def sub(self, lo: int, hi: int, device) -> "CameraBatch":
        """Cameras [lo, hi) on ``device``, padded dims unchanged."""
        return dataclasses.replace(
            self,
            widths=self.widths[lo:hi],
            heights=self.heights[lo:hi],
            **{
                f: getattr(self, f)[lo:hi].to(device)
                for f in CAMERA_TENSORS if getattr(self, f) is not None
            },
        )

    @staticmethod
    def from_jax_fields(batch, width_pad: int, height_pad: int, *, device) -> "CameraBatch":
        """Copy a ``gs2pc.camera.CameraBatch`` (bit-packed masks unpacked)."""

        def conv(x):
            return torch.tensor(np.asarray(x), device=device)

        mask = None
        if batch.mask is not None:
            bits = np.unpackbits(np.asarray(batch.mask), axis=1)
            mask = conv(bits[:, : width_pad * height_pad])
        return CameraBatch(
            viewmatrix=conv(batch.viewmatrix),
            projmatrix=conv(batch.projmatrix),
            campos=conv(batch.campos),
            tanfovx=conv(batch.tanfovx),
            tanfovy=conv(batch.tanfovy),
            focal_x=conv(batch.focal_x),
            focal_y=conv(batch.focal_y),
            widths=tuple(int(w) for w in np.asarray(batch.width)),
            heights=tuple(int(h) for h in np.asarray(batch.height)),
            mask=mask,
            width_pad=width_pad,
            height_pad=height_pad,
        )


def build_camera_batch(
    transforms: dict,
    intrinsics: dict,
    colour_resolution: Optional[int] = None,
    masks: Optional[dict] = None,
    tile: int = 16,
    *,
    device,
) -> CameraBatch:
    """Stack every camera; padded dims are the max over cameras rounded up
    to the tile size."""
    cams = []
    for name, transform in transforms.items():
        mask = None if masks is None else masks.get(name)
        cams.append(
            make_camera(
                np.asarray(transform, np.float64), intrinsics[name],
                colour_resolution=colour_resolution, mask=mask,
            )
        )
    if not cams:
        raise ValueError("No cameras to render")

    w_pad = -(-max(int(c["width"]) for c in cams) // tile) * tile
    h_pad = -(-max(int(c["height"]) for c in cams) // tile) * tile

    mask_stack = None
    if any(c["mask"] is not None for c in cams):
        mask_stack = np.ones((len(cams), h_pad * w_pad), np.uint8)
        for i, c in enumerate(cams):
            if c["mask"] is not None:
                m = np.zeros((h_pad, w_pad), np.uint8)
                mm = np.asarray(c["mask"]) != 0
                m[: mm.shape[0], : mm.shape[1]] = mm
                mask_stack[i] = m.reshape(-1)

    def stack(key):
        return torch.as_tensor(np.stack([c[key] for c in cams]), device=device)

    return CameraBatch(
        viewmatrix=stack("viewmatrix"),
        projmatrix=stack("projmatrix"),
        campos=stack("campos"),
        tanfovx=stack("tanfovx"),
        tanfovy=stack("tanfovy"),
        focal_x=stack("focal_x"),
        focal_y=stack("focal_y"),
        widths=tuple(int(c["width"]) for c in cams),
        heights=tuple(int(c["height"]) for c in cams),
        mask=None if mask_stack is None else torch.as_tensor(mask_stack, device=device),
        width_pad=w_pad,
        height_pad=h_pad,
    )
