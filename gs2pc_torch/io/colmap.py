"""COLMAP camera/pose loaders (bin and txt) + transforms dispatch (counterpart
of gs2pc.io.colmap, which reaches JAX through its logger).

Reference parity: transform_dataloader.py:8-211, :280-299.  Pure host
numpy/struct; returns NeRF-convention c2w matrices keyed by image basename.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

from gs2pc_torch.utils import log

_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def convert_sfm_pose_to_nerf(transform: np.ndarray) -> np.ndarray:
    """w2c -> c2w with the NeRF axis flip (transform_dataloader.py:8-22)."""
    return np.linalg.inv(transform) @ _FLIP


def qvec2rotmat(qvec) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (transform_dataloader.py:24-42)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _pose_from_qvec_tvec(qvec, tvec) -> list:
    """COLMAP image line -> flipped c2w (transform_dataloader.py:98-117).

    Note the reference negates the quaternion before conversion
    (``qvec2rotmat(-qvec)``) and treats [R|t] as the matrix it inverts.
    """
    qvec = np.asarray(qvec, np.float64)
    tvec = np.asarray(tvec, np.float64).reshape(3, 1)
    R = qvec2rotmat(-qvec)
    c2w = np.concatenate(
        [np.concatenate([R, tvec], axis=1), np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0
    )
    return convert_sfm_pose_to_nerf(c2w).tolist()


# ------------------------------------------------------------------ #
# cameras.bin / cameras.txt
# ------------------------------------------------------------------ #

def read_colmap_bin_intrinsics(file_path: str) -> Dict[int, tuple]:
    """cameras.bin -> {camera_id: (w, h, fx, fy)} (transform_dataloader.py:50-71)."""
    intrinsics = {}
    with open(file_path, "rb") as fh:
        (num_cameras,) = struct.unpack("<Q", fh.read(8))
        for _ in range(num_cameras):
            elems = struct.unpack("<iiQQdddd", fh.read(56))
            camera_id = elems[0]
            if elems[1] != 1:
                log.warn(
                    "non-PINHOLE COLMAP camera model found; intrinsics are "
                    "treated as pinhole, which may degrade rendered colours"
                )
            intrinsics[camera_id] = elems[2:]
    return intrinsics


def read_colmap_txt_intrinsics(file_path: str) -> Dict[int, tuple]:
    """cameras.txt -> {camera_id: (w, h, fx, fy, ...)} (transform_dataloader.py:73-96)."""
    intrinsics = {}
    with open(file_path, "r") as fh:
        for line in fh:
            line = line.strip()
            if len(line) == 0 or line[0] == "#":
                continue
            elems = line.split(" ")
            camera_id = int(elems[0])
            if elems[1].lower().strip() != "pinhole":
                log.warn(
                    "non-PINHOLE COLMAP camera model found; intrinsics are "
                    "treated as pinhole, which may degrade rendered colours"
                )
            intrinsics[camera_id] = tuple(elems[2:])
    return intrinsics


# ------------------------------------------------------------------ #
# images.bin / images.txt
# ------------------------------------------------------------------ #

def load_colmap_bin_data(input_path: str, skip_rate: int = 0) -> Tuple[dict, dict]:
    """COLMAP binary directory -> ({name: c2w}, {name: intrinsics}).

    Parity: transform_dataloader.py:119-171 (incl. skip_rate subsampling
    and basename-sans-extension keys).
    """
    transforms, cameras = {}, {}
    colmap_cameras = read_colmap_bin_intrinsics(os.path.join(input_path, "cameras.bin"))
    images_path = os.path.join(input_path, "images.bin")

    i = 0
    with open(images_path, "rb") as fh:
        (num_images,) = struct.unpack("<Q", fh.read(8))
        for _ in range(num_images):
            elems = struct.unpack("<idddddddi", fh.read(64))
            qvec, tvec = elems[1:5], elems[5:8]
            camera_id = elems[8]

            name_bytes = b""
            char = fh.read(1)
            while char != b"\x00":
                name_bytes += char
                char = fh.read(1)
            name = name_bytes.decode("utf-8")

            (num_points2d,) = struct.unpack("<Q", fh.read(8))
            fh.seek(24 * num_points2d, os.SEEK_CUR)

            if i % (skip_rate + 1) == 0:
                key = os.path.basename(name).split(".")[0]
                transforms[key] = _pose_from_qvec_tvec(qvec, tvec)
                cameras[key] = colmap_cameras[camera_id]
            i += 1
    return transforms, cameras


def load_colmap_txt_data(input_path: str, skip_rate: int = 0) -> Tuple[dict, dict]:
    """COLMAP text directory (every 2nd non-comment line is a pose line).

    Parity: transform_dataloader.py:173-211.
    """
    transforms, cameras = {}, {}
    colmap_cameras = read_colmap_txt_intrinsics(os.path.join(input_path, "cameras.txt"))

    i = 0
    with open(os.path.join(input_path, "images.txt"), "r") as fh:
        for line in fh:
            line = line.strip()
            if len(line) != 0 and line[0] == "#":
                continue
            i += 1
            if len(line) == 0:
                continue
            if i % 2 == 1 and i % (skip_rate + 1) == 0:
                elems = line.split(" ")
                camera_id = int(elems[8])
                key = os.path.basename(elems[9]).split(".")[0]
                qvec = [float(v) for v in elems[1:5]]
                tvec = [float(v) for v in elems[5:8]]
                transforms[key] = _pose_from_qvec_tvec(qvec, tvec)
                cameras[key] = colmap_cameras[camera_id]
    return transforms, cameras


# ------------------------------------------------------------------ #
# Dispatch (transform_dataloader.py:280-299)
# ------------------------------------------------------------------ #

def load_transform_data(input_path: str, skip_rate: int = 0) -> Tuple[dict, dict]:
    """Directory -> COLMAP txt/bin (also <dir>/sparse/0); file -> .json."""
    from gs2pc_torch.io.transforms_json import load_transform_json_data

    if os.path.isdir(input_path):
        if os.path.exists(os.path.join(input_path, "images.txt")):
            return load_colmap_txt_data(input_path, skip_rate=skip_rate)
        if os.path.exists(os.path.join(input_path, "images.bin")):
            return load_colmap_bin_data(input_path, skip_rate=skip_rate)
        nested = os.path.join(input_path, "sparse", "0")
        if os.path.exists(nested):
            if os.path.exists(os.path.join(nested, "images.txt")):
                return load_colmap_txt_data(nested, skip_rate=skip_rate)
            if os.path.exists(os.path.join(nested, "images.bin")):
                return load_colmap_bin_data(nested, skip_rate=skip_rate)
    else:
        if os.path.splitext(input_path)[1] == ".json":
            return load_transform_json_data(input_path, skip_rate=skip_rate)

    raise AttributeError("Unsupported transform data type")
