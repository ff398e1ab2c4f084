"""Point-cloud PLY output (counterpart of gs2pc.io.ply.save_point_cloud_ply).

The cloud is host-resident: positions (N, 3) and per-Gaussian uint8
colours / normals that expand over the per-Gaussian point counts (points
are slot-major, so colours and normals are row repeats).  The bytes match
the JAX package's writer: binary little-endian, float32 x y z [nx ny nz],
uchar red green blue.  The native C++ expand-writer of gs2pc.native packs
and writes when it builds; otherwise numpy does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray  # (total, 3) float32
    counts: np.ndarray  # (P,) int64 points per Gaussian, summing to total
    cols_u8: np.ndarray  # (P, 3) uint8
    gauss_normals: Optional[np.ndarray]  # (P, 3) float32 or None

    @property
    def total(self) -> int:
        return int(self.points.shape[0])

    def gauss_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.counts.shape[0], dtype=np.int64), self.counts)

    @property
    def normals(self) -> Optional[np.ndarray]:
        if self.gauss_normals is None:
            return None
        return self.gauss_normals[self.gauss_ids()]


def ply_header(total: int, with_normals: bool) -> bytes:
    props = ["float x", "float y", "float z"]
    if with_normals:
        props += ["float nx", "float ny", "float nz"]
    props += ["uchar red", "uchar green", "uchar blue"]
    body = "".join(f"property {p}\n" for p in props)
    return (
        f"ply\nformat binary_little_endian 1.0\nelement vertex {total}\n{body}end_header\n"
    ).encode("utf-8")


def _native_expand(cloud: PointCloud, filename: str, chunk_size: int) -> bool:
    from gs2pc.native import load as load_native

    lib = load_native()
    if lib is None:
        return False
    pts = np.ascontiguousarray(cloud.points, np.float32)
    counts = np.ascontiguousarray(cloud.counts, np.int64)
    cols = np.ascontiguousarray(cloud.cols_u8, np.uint8)
    nrm = None if cloud.gauss_normals is None else np.ascontiguousarray(
        cloud.gauss_normals, np.float32
    )
    rc = lib.gs2pc_write_ply_expand(
        filename.encode(), cloud.total,
        pts.ctypes.data_as(ctypes.c_void_p), counts.ctypes.data_as(ctypes.c_void_p),
        int(counts.shape[0]), cols.ctypes.data_as(ctypes.c_void_p),
        None if nrm is None else nrm.ctypes.data_as(ctypes.c_void_p), int(chunk_size),
    )
    return rc == 0


def save_point_cloud_ply(cloud: PointCloud, filename: str, chunk_size: int = 10**6) -> str:
    """Write ``cloud``; returns which writer ran ("native_expand" or "numpy")."""
    if int(cloud.counts.sum()) != cloud.total:
        raise ValueError("point counts must sum to the number of points")
    if _native_expand(cloud, filename, chunk_size):
        return "native_expand"
    with_normals = cloud.gauss_normals is not None
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if with_normals:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    gid = cloud.gauss_ids()
    with open(filename, "wb") as fh:
        fh.write(ply_header(cloud.total, with_normals))
        for lo in range(0, cloud.total, chunk_size):
            hi = min(lo + chunk_size, cloud.total)
            v = np.zeros(hi - lo, dtype=fields)
            pts = cloud.points[lo:hi]
            v["x"], v["y"], v["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            g = gid[lo:hi]
            if with_normals:
                nrm = cloud.gauss_normals[g]
                v["nx"], v["ny"], v["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
            cols = cloud.cols_u8[g]
            v["red"], v["green"], v["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
            fh.write(v.tobytes())
    return "numpy"
