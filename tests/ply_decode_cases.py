"""Records of 3DGS exports for the scene load's record decode
(gs2pc_torch.ops.plydecode), shared by the CPU tests against the host parse
(test_torch_ply_decode.py) and the card tests (test_torch_cuda.py).  numpy
and torch only: the card tests import no JAX.

``records`` draws float32 rows of a layout (the INRIA export with or
without normals, or degree 0), with the edge rows (``edge_rows``) spread
over them: zero and negative-w quaternions, -0.0, colours on exact
quantisation ties (``quantisation_ties``) and past both clip ends, NaN with
payloads and +-inf in f_dc, rot_*, scale_* and xyz.
"""

import numpy as np

from gs2pc_torch.io import gaussians_io
from gs2pc_torch.io.ply import PlyElement

INRIA = (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
         + [f"f_rest_{i}" for i in range(45)]
         + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"])
NO_NORMALS = [p for p in INRIA if p not in ("nx", "ny", "nz")]
SH0 = [p for p in INRIA if not p.startswith("f_rest_")]
LAYOUTS = {"inria": (INRIA, 3), "inria_no_normals": (NO_NORMALS, 3), "sh0": (SH0, 0)}

# NaNs with payloads, quiet and signalling, of both signs.
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7FC01234, 0xFFC54321, 0x7F800001, 0xFF812345,
                 0x7FFFFFFF], np.uint32).view(np.float32)
SHIFTS = (-1, 1, 0, -2, 2, -3, 3)


def _f32(v):
    return np.float32(v)


def quantisation_ties():
    """f_dc values whose colour, clip(SH_C0 * f + 0.5, 0, 1), times 255 is
    k + 0.5 exactly, for every k that has one (float32 arithmetic)."""
    c0, found = _f32(gaussians_io.SH_C0), []
    for k in range(255):
        tie = _f32(k + 0.5)
        for c in (np.nextafter(_f32(tie / 255), _f32(s * np.inf)) if s else _f32(tie / 255)
                  for s in SHIFTS):
            if _f32(c * _f32(255.0)) != tie:
                continue
            f = _f32((c - _f32(0.5)) / c0)
            for _ in range(64):
                got = _f32(c0 * f) + _f32(0.5)
                if got == c:
                    found.append(f)
                    break
                f = np.nextafter(f, _f32(np.inf) if got < c else _f32(-np.inf))
            break
    return np.array(found, np.float32)


def edge_rows(props):
    """Rows of the edge cases, each a dict of field values (the rest
    random)."""
    rows = []
    rot = [f"rot_{i}" for i in range(4)]
    for q in ([0, 0, 0, 0], [-0.0, 0, 0, 0], [-0.0, -0.0, -0.0, -0.0], [-0.3, 0.2, 0.1, 0.9],
              [-0.0, 0.5, -0.5, 0.1], [-1e-30, 0, 0, 0], [3e38, 3e38, 0, 0], [1e-40, 0, 0, -1e-41],
              [np.inf, 0, 0, 0], [-np.inf, 1, 0, 0], [np.inf, -np.inf, 0, 0], [1, np.inf, 0, 2],
              [NANS[2], 1, 0, 0], [1, NANS[3], NANS[2], 0], [-1, 0, 0, NANS[5]],
              [NANS[4], NANS[1], 0, 0], [np.inf, NANS[2], 0, 0], [-2, NANS[6], np.inf, 0]):
        rows.append(dict(zip(rot, q)))
    dc = ["f_dc_0", "f_dc_1", "f_dc_2"]
    ties = quantisation_ties()
    for i in range(0, ties.size, 3):
        rows.append(dict(zip(dc, ties[i:i + 3])))
    for v in ([10.0, -10.0, 1e30], [-1e30, np.inf, -np.inf], [-0.0, 0.0, 1.7724539],
              [-1.7724539, 1.7724538, -1.7724540], [NANS[0], NANS[1], NANS[2]],
              [NANS[4], NANS[5], np.inf], [1e-45, -1e-45, NANS[6]]):
        rows.append(dict(zip(dc, v)))
    for v in ([np.inf, -np.inf, NANS[3]], [NANS[4], -0.0, 1e-40]):
        rows.append(dict(zip(["scale_0", "scale_1", "scale_2"], v)))
        rows.append(dict(zip(["x", "y", "z"], v)))
    rows.append({"opacity": 80.0, "f_rest_3": NANS[5], "f_rest_44": -np.inf})
    return [{k: v for k, v in r.items() if k in props} for r in rows]


def records(props, n, seed, edges):
    """``n`` float32 records of ``props`` (normal x 1.7), with the edge
    rows spread over them when ``edges``."""
    r = np.random.default_rng(seed)
    data = np.zeros(n, [(p, "<f4") for p in props])
    for p in props:
        data[p] = r.normal(size=n) * 1.7
    if edges:
        rows = edge_rows(props)
        assert len(rows) <= n
        for at, row in zip(r.choice(n, len(rows), replace=False), rows):
            for k, v in row.items():
                data[k][at] = v
    return data


def write_ply(path, data):
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {data.shape[0]}\n"
              + "".join(f"property float {p}\n" for p in data.dtype.names) + "end_header\n")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(data.tobytes())
    return str(path)


def host_planes(data, degree, with_shs, compact):
    """_Planes.fill's planes of the records ``data``."""
    planes = gaussians_io._Planes(data.dtype.names, data.shape[0], degree, with_shs,
                                  lambda name, shape: np.empty(shape, np.float32), compact)
    planes.fill(data, 0, span=gaussians_io._untimed)
    return {"xyz": planes.xyz, "colours": planes.colours, "log_scales": planes.log_scales,
            "rots": planes.rots, "shs": planes.shs}


def card_layout(data, degree):
    vertex = PlyElement("vertex", data.shape[0])
    vertex.properties = [(p, "f4") for p in data.dtype.names]
    return gaussians_io._card_layout("binary_little_endian", vertex, degree)


def assert_bits_equal(got, want, name):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
    differ = got.view(np.uint32) != want.view(np.uint32)
    assert not differ.any(), (name, np.argwhere(differ)[:5], got[differ][:5], want[differ][:5])
