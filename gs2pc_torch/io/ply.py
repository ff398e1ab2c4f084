"""PLY input and point-cloud output (the port's copy of gs2pc.io.ply's
reader, and the counterpart of its save_point_cloud_ply).

Reading: ``read_ply`` is the JAX package's dependency-free numpy codec
(binary little/big endian and ascii, scalar properties; list properties
only through the row-wise path), its header parse split out as
``read_ply_header`` for the scene loader's block parse.

Writing: a cloud is positions (N, 3) and per-Gaussian uint8 colours /
normals that expand over the per-Gaussian point counts (points are
slot-major, so colours and normals are row repeats).  An eager
``PointCloud`` holds its positions on the host; a lazy one
(gs2pc_torch.pipeline.LazyPointCloud) keeps them on the device and hands
them over a chunk at a time, the next chunk's copy in flight while the
current one is written, as the JAX package streams its LazyPointCloud.
The bytes match the JAX package's writer: binary little-endian, float32
x y z [nx ny nz], uchar red green blue.  The native C++ writer
(``csrc/plyio.cpp``, built with g++ at first use) packs and writes, in one
call or chunk by chunk; where no g++ is found or the build fails, numpy
does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import io
from typing import Optional

import numpy as np

_PLY_TYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


class PlyElement:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.properties: list[tuple[str, str]] = []  # (name, numpy dtype str)
        self.data: Optional[np.ndarray] = None

    def __getitem__(self, prop: str) -> np.ndarray:
        return self.data[prop]

    @property
    def property_names(self) -> list[str]:
        return [p[0] for p in self.properties]


def read_ply_header(fh, path: str) -> tuple[str, list[PlyElement]]:
    """The format and the elements (properties, no data) of the PLY open as
    ``fh``, which is left at the first byte of the body."""
    magic = fh.readline().strip()
    if magic != b"ply":
        raise AttributeError(f"{path} is not a PLY file")

    fmt = None
    elements: list[PlyElement] = []
    while True:
        line = fh.readline()
        if not line:
            raise AttributeError("Unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1].properties.append(
                    (tokens[4], f"LIST:{_PLY_TYPES[tokens[2]]}:{_PLY_TYPES[tokens[3]]}")
                )
            else:
                elements[-1].properties.append((tokens[2], _PLY_TYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break

    if fmt is None:
        raise AttributeError("PLY header missing format line")
    return fmt, elements


def has_list(elem: PlyElement) -> bool:
    return any(t.startswith("LIST:") for _, t in elem.properties)


def scalar_dtype(elem: PlyElement, fmt: str) -> np.dtype:
    """The record dtype of a binary element with scalar properties."""
    endian = "<" if fmt != "binary_big_endian" else ">"
    return np.dtype([(n, endian + t) for n, t in elem.properties])


def read_ply(path: str) -> dict[str, PlyElement]:
    """Parse a PLY file; returns elements keyed by name.

    Supports binary_little_endian, binary_big_endian and ascii formats with
    scalar properties (list properties are only needed for faces; vertex
    clouds — the only thing the pipeline reads — never use them).
    """
    with open(path, "rb") as fh:
        fmt, elements = read_ply_header(fh, path)
        endian = "<" if fmt != "binary_big_endian" else ">"
        for elem in elements:
            if fmt == "ascii":
                _read_ascii_element(fh, elem)
            elif has_list(elem):
                _read_binary_list_element(fh, elem, endian)
            else:
                dtype = scalar_dtype(elem, fmt)
                buf = fh.read(dtype.itemsize * elem.count)
                elem.data = np.frombuffer(buf, dtype=dtype, count=elem.count)
    return {e.name: e for e in elements}


def _read_ascii_element(fh, elem: PlyElement) -> None:
    if has_list(elem):
        # parse row by row, keeping only scalar leading properties
        rows = []
        for _ in range(elem.count):
            rows.append(fh.readline().decode("ascii").split())
        scalars = [(n, t) for n, t in elem.properties if not t.startswith("LIST:")]
        data = np.zeros(elem.count, dtype=[(n, t) for n, t in scalars])
        for i, row in enumerate(rows):
            for j, (n, _) in enumerate(scalars):
                data[n][i] = float(row[j])
        elem.data = data
        return
    text = b"".join(fh.readline() for _ in range(elem.count))
    flat = np.loadtxt(io.BytesIO(text), ndmin=2)
    data = np.zeros(elem.count, dtype=[(n, t) for n, t in elem.properties])
    for j, (n, _) in enumerate(elem.properties):
        data[n] = flat[:, j]
    elem.data = data


def _read_binary_list_element(fh, elem: PlyElement, endian: str) -> None:
    # Generic row-wise fallback (faces etc.); vertex clouds never hit this.
    names, vals = [], []
    for n, t in elem.properties:
        if not t.startswith("LIST:"):
            names.append((n, t))
    rows = {n: [] for n, _ in names}
    lists: dict[str, list] = {
        n: [] for n, t in elem.properties if t.startswith("LIST:")
    }
    for _ in range(elem.count):
        for n, t in elem.properties:
            if t.startswith("LIST:"):
                _, cnt_t, val_t = t.split(":")
                cnt = int(np.frombuffer(fh.read(np.dtype(cnt_t).itemsize), endian + cnt_t)[0])
                lists[n].append(
                    np.frombuffer(fh.read(cnt * np.dtype(val_t).itemsize), endian + val_t)
                )
            else:
                rows[n].append(np.frombuffer(fh.read(np.dtype(t).itemsize), endian + t)[0])
    data = np.zeros(elem.count, dtype=[(n, t) for n, t in names])
    for n, _ in names:
        data[n] = rows[n]
    elem.data = data
    elem.lists = lists  # type: ignore[attr-defined]


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
    from gs2pc_torch.ops.cuda_build import load_plyio

    lib = load_plyio()
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


def _native_stream(lib, cloud, filename: str, chunk_size: int) -> None:
    """Write a lazy cloud through the native session: each chunk of rows is
    packed and queued on the writer thread while the next chunk's copy to
    the host is in flight (``cloud.point_rows``); raises on any failure."""
    offs = np.zeros(cloud.counts.shape[0] + 1, np.int64)
    np.cumsum(cloud.counts, out=offs[1:])
    cols = np.ascontiguousarray(cloud.cols_u8, np.uint8)
    nrm = None if cloud.gauss_normals is None else np.ascontiguousarray(
        cloud.gauss_normals, np.float32
    )
    cols_p = cols.ctypes.data_as(ctypes.c_void_p)
    nrm_p = None if nrm is None else nrm.ctypes.data_as(ctypes.c_void_p)
    handle = lib.gs2pc_ply_open(filename.encode(), cloud.total, int(nrm is not None))
    if handle is None:
        raise OSError(f"gs2pc_ply_open: cannot write {filename}")
    try:
        for lo, pts in cloud.point_rows(chunk_size):
            if pts.dtype != np.float32 or not pts.flags["C_CONTIGUOUS"]:
                raise ValueError("point chunks must be C-contiguous float32 rows")
            rc = lib.gs2pc_ply_write_chunk(
                handle, pts.ctypes.data_as(ctypes.c_void_p), lo, lo + pts.shape[0],
                offs.ctypes.data_as(ctypes.c_void_p), int(cols.shape[0]), cols_p, nrm_p,
            )
            if rc != 0:
                raise OSError(f"gs2pc_ply_write_chunk: rows from {lo} failed ({rc})")
    finally:
        rc = lib.gs2pc_ply_close(handle)
    if rc != 0:
        raise OSError(f"gs2pc_ply_close: writing {filename} failed ({rc})")


def _eager_chunks(cloud: PointCloud, chunk_size: int):
    gid = cloud.gauss_ids()
    for lo in range(0, cloud.total, chunk_size):
        hi = min(lo + chunk_size, cloud.total)
        g = gid[lo:hi]
        yield (cloud.points[lo:hi], cloud.cols_u8[g],
               None if cloud.gauss_normals is None else cloud.gauss_normals[g])


def _write_numpy(filename: str, total: int, with_normals: bool, chunks) -> None:
    """Pack (points, colours u8, normals or None) chunks with numpy."""
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if with_normals:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    with open(filename, "wb") as fh:
        fh.write(ply_header(total, with_normals))
        for pts, cols, nrm in chunks:
            v = np.zeros(pts.shape[0], dtype=fields)
            v["x"], v["y"], v["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            if with_normals:
                v["nx"], v["ny"], v["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
            v["red"], v["green"], v["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
            fh.write(v.tobytes())


def save_point_cloud_ply(cloud, filename: str, chunk_size: int = 10**6) -> str:
    """Write ``cloud``; returns which writer ran.

    A lazy cloud (one with ``stream_chunks``: pipeline.LazyPointCloud, its
    points still on the device) streams: "native_stream" through the native
    session, else "numpy_stream", chunk by chunk.  An eager ``PointCloud``
    is written by "native_expand", else "numpy".  All four write the same
    bytes."""
    if int(cloud.counts.sum()) != cloud.total:
        raise ValueError("point counts must sum to the number of points")
    with_normals = cloud.gauss_normals is not None
    if hasattr(cloud, "stream_chunks"):
        from gs2pc_torch.ops.cuda_build import load_plyio

        lib = load_plyio()
        if lib is not None:
            _native_stream(lib, cloud, filename, chunk_size)
            return "native_stream"
        _write_numpy(filename, cloud.total, with_normals, cloud.stream_chunks(chunk_size))
        return "numpy_stream"
    if _native_expand(cloud, filename, chunk_size):
        return "native_expand"
    _write_numpy(filename, cloud.total, with_normals, _eager_chunks(cloud, chunk_size))
    return "numpy"
