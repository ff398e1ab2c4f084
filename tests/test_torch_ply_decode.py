"""The scene load's record decode (gs2pc_torch.ops.plydecode, the kernel
csrc/plydecode.cu and its twin ply_decode_torch) against the host parse
(gs2pc_torch.io.gaussians_io._Planes.fill), bit for bit on raw record
bytes: random rows and the edge rows (a zero quaternion, w < 0 and -0.0,
colours on exact quantisation ties and past both clip ends, NaN with
payloads and +-inf in f_dc, rot_* and scale_*), the INRIA layout with and
without normals, with_shs on and off, compact colours on and off.  Then
the card path's steps (_decode_on_card: staging, the blocks over threads,
the opacities on the host) on CPU tensors against load_ply_gaussians, with
a row count that is not a multiple of the block; which headers take the
card path; and the kernel's constants against numpy's float32."""

import os
import re

import numpy as np
import pytest
import torch

from gs2pc_torch.io import gaussians_io
from gs2pc_torch.ops import plydecode
from gs2pc_torch.utils import log
from tests.ply_decode_cases import (INRIA, LAYOUTS, NO_NORMALS, SH0, assert_bits_equal,
                                    card_layout, edge_rows, host_planes, quantisation_ties,
                                    records, write_ply)

ROWS = 131
BLOCK = 8  # ROWS is 16 full blocks and a partial one, and holds every edge row


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("with_shs", [False, True], ids=["no_shs", "shs"])
@pytest.mark.parametrize("kind", ["inria", "inria_no_normals", "sh0"])
@pytest.mark.parametrize("data", ["random", "edges"])
def test_twin_equals_host_fill(kind, with_shs, compact, data):
    """ply_decode_torch on the raw record bytes, a block at a time at
    their rows, gives _Planes.fill's planes bit for bit."""
    props, degree = LAYOUTS[kind]
    recs = records(props, 257, seed=3, edges=data == "edges")
    want = host_planes(recs, degree, with_shs, compact)
    layout = card_layout(recs, degree)
    assert layout is not None and layout.stride == 4 * len(props)
    got = {name: torch.full(w.shape, float("nan")) for name, w in want.items() if w is not None}
    raw = torch.from_numpy(recs.view(np.uint8).copy())
    for lo in range(0, 257, 100):
        rows = min(100, 257 - lo)
        block = raw[lo * layout.stride:(lo + rows) * layout.stride].clone()
        plydecode.ply_decode(block, rows, lo, layout, got, compact)
    assert ("shs" in got) == with_shs
    for name, plane in got.items():
        assert_bits_equal(plane.numpy(), want[name], name)


def test_edge_rows_reach_their_cases():
    """The edge rows give what they stand for on the host: the 1e-12 clamp,
    a flipped w, a kept -0.0 w, the default NaN of inf / inf, NaN payloads
    through the colour clip, NaN to level 0, and ties rounded to even."""
    recs = records(INRIA, len(edge_rows(INRIA)), seed=1, edges=True)
    p = host_planes(recs, 3, False, True)
    rots, cols = p["rots"].view(np.uint32), p["colours"]
    raw = np.stack([recs[f"rot_{i}"] for i in range(4)], 1)
    assert (p["rots"][(raw == 0).all(1)] == 0).all()
    assert (rots == 0xFFC00000).any() and (rots == 0x7FC01234).any()
    assert (p["rots"][:, 0] >= 0).sum() + np.isnan(p["rots"][:, 0]).sum() == len(recs)
    assert ((rots[:, 0] == 0x80000000) & ~np.isnan(p["rots"][:, 1:]).any(1)).any()
    assert (cols == 0).any() and (cols == 1).any()
    full = host_planes(recs, 3, False, False)["colours"]
    assert (full.view(np.uint32) == 0x7FC01234).any() and (full.view(np.uint32) == 0xFFC00000).any()
    ties = quantisation_ties()
    assert ties.size > 150
    f32 = np.float32
    levels = np.clip(f32(gaussians_io.SH_C0) * ties + f32(0.5), 0, 1) * f32(255.0)
    assert (levels % 1 == 0.5).all()
    assert (np.round(levels) % 2 == 0).all()


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("with_shs", [False, True], ids=["no_shs", "shs"])
@pytest.mark.parametrize("kind", ["inria", "inria_no_normals"])
def test_card_path_steps_equal_the_host_parse(tmp_path, monkeypatch, kind, with_shs, compact,
                                              workers):
    """_decode_on_card on CPU tensors (staging, the blocks over threads,
    the opacities on the host, ply_decode's twin) over 131 rows, the edge
    rows among them, in blocks of 8 gives load_ply_gaussians' planes bit
    for bit, the opacities in the host plane it allocates; it logs the
    "blocks_card" reader and opens the parse's spans."""
    props, degree = LAYOUTS[kind]
    path = write_ply(tmp_path / "scene.ply", records(props, ROWS, seed=5, edges=True))
    monkeypatch.setattr(gaussians_io, "CARD_BLOCK_ROWS", BLOCK)
    monkeypatch.setattr(gaussians_io, "MAX_WORKERS", workers)
    want = gaussians_io.load_ply_gaussians(path, max_sh_degree=degree, with_shs=with_shs,
                                           compact_colours=compact)
    lines = []
    monkeypatch.setattr(log, "info", lambda msg="": lines.append(msg))
    log.reset_phases()
    fmt, vertex, body = gaussians_io._read_header(path)
    layout = gaussians_io._card_layout(fmt, vertex, degree)
    host = gaussians_io._HostPlanes(torch.device("cpu"))
    got = gaussians_io._decode_on_card(path, fmt, vertex, body, layout, with_shs, compact, host,
                                       torch.device("cpu"))
    assert list(got) == ["xyz", "colours"] + ["shs"] * with_shs + ["log_scales", "rots"]
    assert list(host.tensors) == ["opacities"]
    got["opacities"] = host.tensors["opacities"]
    for name, i in gaussians_io_order().items():
        if want[i] is None:
            assert name not in got
        else:
            assert_bits_equal(got[name].numpy(), want[i], name)
    assert lines == [f"[gs2pc_torch] ply parse: blocks_card reader, {-(-ROWS // BLOCK)} blocks, "
                     f"f_rest {'copied' if with_shs else 'skipped'}"]
    assert {"ply_read", "ply_columns", "ply_sh_rest"} <= set(log.PHASE_SECONDS)


def gaussians_io_order():
    """load_ply_gaussians' tuple positions by plane name."""
    return {"xyz": 0, "log_scales": 1, "rots": 2, "colours": 3, "opacities": 4, "shs": 5}


def test_card_path_blocks_over_more_threads_than_cores(tmp_path, monkeypatch):
    """One row a block over 32 threads, the interpreter switching threads
    every microsecond: each block's planes and opacities still land in its
    own rows."""
    import sys

    path = write_ply(tmp_path / "scene.ply", records(INRIA, ROWS, seed=6, edges=True))
    monkeypatch.setattr(gaussians_io, "CARD_BLOCK_ROWS", 1)
    monkeypatch.setattr(gaussians_io, "MAX_WORKERS", 32)
    monkeypatch.setattr(gaussians_io.os, "sched_getaffinity", lambda pid: set(range(32)),
                        raising=False)
    want = gaussians_io.load_ply_gaussians(path, with_shs=True, compact_colours=True)
    fmt, vertex, body = gaussians_io._read_header(path)
    host = gaussians_io._HostPlanes(torch.device("cpu"))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = gaussians_io._decode_on_card(path, fmt, vertex, body,
                                           gaussians_io._card_layout(fmt, vertex, 3), True,
                                           True, host, torch.device("cpu"))
    finally:
        sys.setswitchinterval(interval)
    got["opacities"] = host.tensors["opacities"]
    for name, i in gaussians_io_order().items():
        assert_bits_equal(got[name].numpy(), want[i], name)


@pytest.mark.parametrize("cut", [1, 248 * 20])
def test_card_path_on_a_short_file_raises(tmp_path, monkeypatch, cut):
    """A body shorter than the header's count raises on the card path too."""
    path = write_ply(tmp_path / "scene.ply", records(INRIA, ROWS, seed=2, edges=False))
    with open(path, "r+b") as fh:
        fh.truncate(fh.seek(0, 2) - cut)
    monkeypatch.setattr(gaussians_io, "CARD_BLOCK_ROWS", BLOCK)
    fmt, vertex, body = gaussians_io._read_header(path)
    layout = gaussians_io._card_layout(fmt, vertex, 3)
    with pytest.raises(ValueError, match=f"the {ROWS} its header gives"):
        gaussians_io._decode_on_card(path, fmt, vertex, body, layout, False, True,
                                     gaussians_io._HostPlanes(torch.device("cpu")),
                                     torch.device("cpu"))


def _header(fmt, props):
    return (f"ply\nformat {fmt} 1.0\nelement vertex 2\n"
            + "".join(f"property {t} {p}\n" for p, t in props) + "end_header\n")


def _floats(names):
    return [(p, "float") for p in names]


@pytest.mark.parametrize("case,card", [
    ("inria", True), ("inria_no_normals", True), ("sh0", True), ("float32_name", True),
    ("ascii", False), ("big_endian", False), ("list", False), ("rgb_uchar", False),
    ("rgb_float", False), ("double", False), ("no_opacity", False), ("no_scales", False),
    ("no_rots", False), ("two_scales", False), ("f_rest_not_degree", False),
])
def test_header_chooses_the_path(tmp_path, case, card):
    """_card_layout takes only a binary little-endian element of scalar
    float32 fields with x y z, f_dc, opacity, scale_0..2, rot_0..3 and the
    degree's f_rest; ascii, big-endian, lists, RGB colours (uchar or
    float), doubles and fields the host fills with constants take the host
    path."""
    fmt, degree, props = "binary_little_endian", 3, _floats(INRIA)
    if case == "inria_no_normals":
        props = _floats(NO_NORMALS)
    elif case == "sh0":
        props, degree = _floats(SH0), 0
    elif case == "float32_name":
        props = [(p, "float32") for p in INRIA]
    elif case == "ascii":
        fmt = "ascii"
    elif case == "big_endian":
        fmt = "binary_big_endian"
    elif case == "list":
        props = props + [("vertex_indices", "list uchar int")]
    elif case.startswith("rgb"):
        colour = "uchar" if case == "rgb_uchar" else "float"
        props = ([(p, t) for p, t in props if not p.startswith("f_")]
                 + [(c, colour) for c in ("red", "green", "blue")])
    elif case == "double":
        props = [(p, "double" if p == "rot_2" else t) for p, t in props]
    elif case == "no_opacity":
        props = [(p, t) for p, t in props if p != "opacity"]
    elif case == "no_scales":
        props = [(p, t) for p, t in props if not p.startswith("scale_")]
    elif case == "no_rots":
        props = [(p, t) for p, t in props if not p.startswith("rot")]
    elif case == "two_scales":
        props = [(p, t) for p, t in props if p != "scale_2"]
    elif case == "f_rest_not_degree":
        degree = 2
    path = tmp_path / "scene.ply"
    path.write_bytes(_header(fmt, props).encode("ascii"))
    fmt_read, vertex, _ = gaussians_io._read_header(str(path))
    layout = gaussians_io._card_layout(fmt_read, vertex, degree)
    assert (layout is not None) == card


def test_kernel_constants_are_numpys_float32():
    """csrc/plydecode.cu's constants: numpy's float32 of SH_C0, 1e-12 and
    1 / 255, x86's default NaN, and the f_rest bound the wrapper checks."""
    src = open(os.path.join(os.path.dirname(plydecode.__file__), "..", "csrc",
                            "plydecode.cu")).read()

    def define(name):
        return int(re.search(rf"#define {name} (0x[0-9a-f]+|\d+)u?\b", src).group(1), 0)

    def bits(v):
        return int(np.float32(v).view(np.uint32))

    assert define("PLY_SH_C0_BITS") == bits(gaussians_io.SH_C0)
    assert define("PLY_EPS_BITS") == bits(1e-12)
    assert define("PLY_INV255_BITS") == bits(1.0 / 255.0)
    with np.errstate(invalid="ignore"):
        inf = np.array([np.inf], np.float32)
        assert define("PLY_DEFAULT_NAN_BITS") == int((inf / inf).view(np.uint32)[0])
    assert define("PLY_MAX_REST") == plydecode.MAX_REST
