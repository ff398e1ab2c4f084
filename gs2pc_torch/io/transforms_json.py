"""NeRF-style transforms.json loader (parity: transform_dataloader.py:213-278);
the port's copy of gs2pc.io.transforms_json."""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


def _probe_image_size(fname: str) -> tuple[int, int]:
    """(width, height) of an image file via PIL (reference uses cv2)."""
    from PIL import Image

    with Image.open(fname) as img:
        return img.width, img.height


def get_transform_intrinsics(transforms: dict, fname: str) -> list:
    """[w, h, fl_x, fl_y] from a transforms dict or image probe.

    Parity: transform_dataloader.py:213-247 (fl_x or camera_angle_x ->
    focal; fl_y falls back to fl_x).
    """
    intrinsics = [0, 0, 0, 0]

    if "w" in transforms and "h" in transforms:
        intrinsics[0] = transforms["w"]
        intrinsics[1] = transforms["h"]
    else:
        if not os.path.exists(fname):
            raise Exception(f"Image with path {fname} does not exist")
        intrinsics[0], intrinsics[1] = _probe_image_size(fname)

    if "fl_x" in transforms:
        intrinsics[2] = transforms["fl_x"]
    elif "camera_angle_x" in transforms:
        intrinsics[2] = 0.5 * intrinsics[0] / np.tan(0.5 * transforms["camera_angle_x"])
    else:
        raise Exception(
            "A focal length (fl_x) or field of view (camera_angle_x) must be provided"
        )

    if "fl_y" in transforms:
        intrinsics[3] = transforms["fl_y"]
    elif "camera_angle_y" in transforms:
        intrinsics[3] = 0.5 * intrinsics[1] / np.tan(0.5 * transforms["camera_angle_y"])
    else:
        intrinsics[3] = intrinsics[2]

    return intrinsics


def load_transform_json_data(input_path: str, skip_rate: int = 0) -> Tuple[dict, dict]:
    """transforms.json -> ({name: c2w 4x4 list}, {name: [w,h,fx,fy]})."""
    with open(input_path, "r") as fh:
        transforms = json.load(fh)

    json_transforms, intrinsics = {}, {}

    all_intrinsics = None
    if "fl_x" in transforms or "camera_angle_x" in transforms:
        all_intrinsics = get_transform_intrinsics(
            transforms, transforms["frames"][0]["file_path"]
        )

    for i, frame in enumerate(transforms["frames"]):
        fname = os.path.basename(frame["file_path"]).split(".")[0]
        if all_intrinsics is None:
            intrinsics[fname] = get_transform_intrinsics(frame, frame["file_path"])
        else:
            intrinsics[fname] = all_intrinsics
        if i % (skip_rate + 1) == 0:
            json_transforms[fname] = frame["transform_matrix"]

    return json_transforms, intrinsics
