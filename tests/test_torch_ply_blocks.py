"""The scene loader's block parse (gs2pc_torch.io.gaussians_io.
load_ply_gaussians) against gs2pc.io.ply.load_ply_gaussians: the planes bit
for bit on every layout, with blocks cut small so the last one is partial
and, where the machine has the cores, spread over threads; the records
reader for ascii; a short file; a conversion's load without the SH
coefficients, which skips the f_rest copy; and a conversion's load into
the host planes it allocates, each scene tensor on its plane's memory off
a card."""

import numpy as np
import pytest

from gs2pc.io import ply as jax_ply
from gs2pc_torch.io import gaussians_io
from gs2pc_torch.utils import log

INRIA = (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
         + [f"f_rest_{i}" for i in range(45)]
         + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"])
RGB_U8 = (["x", "y", "z", "red", "green", "blue", "opacity"]
          + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
ROWS = 61
BLOCK = 8  # ROWS is 7 full blocks and a partial one


def write_ply(path, props, n, seed=0, fmt="binary_little_endian", late_bright=False):
    """A vertex element of ``props`` ((name, PLY type) pairs) with ``n`` rows
    of random values; uchar colours in {0, 1}, except one row of the last
    block at 200 when ``late_bright``."""
    r = np.random.default_rng(seed)
    endian = ">" if fmt == "binary_big_endian" else "<"
    np_type = {"float": "f4", "double": "f8", "uchar": "u1"}
    data = np.zeros(n, [(p, endian + np_type[t]) for p, t in props])
    for p, t in props:
        data[p] = r.integers(0, 2, n) if t == "uchar" else r.normal(size=n) * 1.7
    if late_bright:
        data["green"][n - 2] = 200
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
              + "".join(f"property {t} {p}\n" for p, t in props) + "end_header\n")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if fmt == "ascii":
            for row in data:
                fh.write((" ".join(repr(float(v)) for v in row) + "\n").encode("ascii"))
        else:
            fh.write(data.tobytes())
    return str(path)


def layout(kind):
    """(props, PLY format, late_bright) of each layout the tests cover."""
    if kind == "inria_sh3":
        return [(p, "float") for p in INRIA], "binary_little_endian", False
    if kind == "sh0":
        return [(p, "float") for p in INRIA if not p.startswith("f_rest_")], \
            "binary_little_endian", False
    if kind == "inria_sh3_big_endian":
        return [(p, "float") for p in INRIA], "binary_big_endian", False
    if kind == "inria_sh3_shuffled":
        # Planes whose fields are not side by side, and doubles among floats.
        props = [(p, "double" if p in ("y", "rot_2", "f_rest_7") else "float") for p in INRIA]
        order = np.random.default_rng(3).permutation(len(props))
        return [props[i] for i in order], "binary_little_endian", False
    if kind == "rgb_uchar_late":
        return [(p, "uchar" if p in ("red", "green", "blue") else "float") for p in RGB_U8], \
            "binary_little_endian", True
    if kind == "rgb_uchar_dim":
        return [(p, "uchar" if p in ("red", "green", "blue") else "float") for p in RGB_U8], \
            "binary_little_endian", False
    raise KeyError(kind)


@pytest.fixture
def parse_lines(monkeypatch):
    """The loader's log lines about which reader ran."""
    lines = []
    monkeypatch.setattr(log, "info", lambda msg="": lines.append(msg))
    return lines


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("kind", ["inria_sh3", "inria_sh3_big_endian", "inria_sh3_shuffled",
                                  "sh0", "rgb_uchar_late", "rgb_uchar_dim"])
def test_blocks_match_jax(tmp_path, monkeypatch, parse_lines, kind, workers):
    """Blocks of 8 rows over 61 (the last partial), on one thread or
    three, give the JAX loader's planes bit for bit: a degree-3 SH export,
    big-endian, with its fields shuffled and mixed with doubles, degree 0
    (f_dc alone), and uchar RGB whose /255 is decided over the whole plane
    (one row of the last block exceeds 1, or none does)."""
    props, fmt, late = layout(kind)
    path = write_ply(tmp_path / "scene.ply", props, ROWS, fmt=fmt, late_bright=late)
    monkeypatch.setattr(gaussians_io, "BLOCK_ROWS", BLOCK)
    monkeypatch.setattr(gaussians_io, "MAX_WORKERS", workers)
    degree = 0 if kind == "sh0" else 3
    got = gaussians_io.load_ply_gaussians(path, max_sh_degree=degree)
    want = jax_ply.load_ply_gaussians(path, max_sh_degree=degree)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if kind.startswith("rgb"):
        assert got[5] is None
        assert (got[3].max() == 1.0) == (kind == "rgb_uchar_dim")
    else:
        assert got[5].shape == (ROWS, 3, (degree + 1) ** 2)
    assert parse_lines == [f"[gs2pc_torch] ply parse: blocks reader, {-(-ROWS // BLOCK)} blocks, "
                           f"f_rest {'skipped' if kind.startswith('rgb') else 'copied'}"]


@pytest.mark.parametrize("kind", ["inria_sh3", "rgb_uchar_late"])
def test_ascii_takes_the_records_reader(tmp_path, parse_lines, kind):
    props, _, late = layout(kind)
    path = write_ply(tmp_path / "scene.ply", props, 9, fmt="ascii", late_bright=late)
    got, want = gaussians_io.load_ply_gaussians(path), jax_ply.load_ply_gaussians(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert parse_lines[0].startswith("[gs2pc_torch] ply parse: records reader, 0 blocks")


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("cut", [1, 248, 248 * 20])
def test_a_short_file_raises(tmp_path, monkeypatch, workers, cut):
    """A body shorter than the header's count raises, wherever it ends."""
    path = write_ply(tmp_path / "scene.ply", layout("inria_sh3")[0], ROWS)
    with open(path, "r+b") as fh:
        fh.truncate(fh.seek(0, 2) - cut)
    monkeypatch.setattr(gaussians_io, "BLOCK_ROWS", BLOCK)
    monkeypatch.setattr(gaussians_io, "MAX_WORKERS", workers)
    with pytest.raises(ValueError, match=f"the {ROWS} its header gives"):
        gaussians_io.load_ply_gaussians(path)


def test_load_without_shs_skips_the_rest(tmp_path, monkeypatch, parse_lines, handover):
    """load_gaussians(with_shs=False) on an SH export: no shs, no "shs"
    plane allocated, the f_rest copy skipped but its span entered, and the
    blocks reader taken."""
    path = write_ply(tmp_path / "scene.ply", layout("inria_sh3")[0], ROWS)
    monkeypatch.setattr(gaussians_io, "BLOCK_ROWS", BLOCK)
    log.reset_phases()
    g = gaussians_io.load_gaussians(path, with_shs=False, device="cpu")
    assert g.shs is None
    assert list(handover) == ["xyz", "opacities", "colours", "log_scales", "rots"]
    assert "ply_sh_rest" in log.PHASE_SECONDS
    assert parse_lines[0] == ("[gs2pc_torch] ply parse: blocks reader, "
                              f"{-(-ROWS // BLOCK)} blocks, f_rest skipped")
    want = jax_ply.load_ply_gaussians(path)
    np.testing.assert_array_equal(g.xyz.numpy(), want[0])
    np.testing.assert_array_equal(g.rots.numpy(), want[2])


def test_blocks_spread_over_more_threads_than_cores(tmp_path, monkeypatch):
    """One row a block over 32 threads, the interpreter switching threads
    every microsecond: each block still lands in its own rows."""
    import sys

    path = write_ply(tmp_path / "scene.ply", layout("inria_sh3")[0], ROWS)
    monkeypatch.setattr(gaussians_io, "BLOCK_ROWS", 1)
    monkeypatch.setattr(gaussians_io, "MAX_WORKERS", 32)
    monkeypatch.setattr(gaussians_io.os, "sched_getaffinity", lambda pid: set(range(32)),
                        raising=False)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = gaussians_io.load_ply_gaussians(path)
    finally:
        sys.setswitchinterval(interval)
    for a, b in zip(got, jax_ply.load_ply_gaussians(path)):
        np.testing.assert_array_equal(a, b)


def _levels(colours):
    """quantise_colours_u8's expressions, written out."""
    c8 = np.round(np.clip(colours.astype(np.float32), 0.0, 1.0) * np.float32(255.0))
    return c8.astype(np.uint8).astype(np.float32) * np.float32(1.0 / 255.0)


@pytest.fixture
def handover(monkeypatch):
    """The host planes load_gaussians allocates, by name, in the order
    asked for."""
    seen = {}
    real = gaussians_io._HostPlanes.__call__

    def alloc(self, name, shape):
        plane = seen[name] = real(self, name, shape)
        return plane

    monkeypatch.setattr(gaussians_io._HostPlanes, "__call__", alloc)
    return seen


SCENE_PLANES = {"xyz": 0, "log_scales": 1, "rots": 2, "colours": 3, "opacities": 4}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("kind", ["inria_sh3", "sh0", "rgb_uchar_late", "rgb_uchar_dim"])
def test_parse_into_lent_planes(tmp_path, monkeypatch, parse_lines, handover, kind, compact,
                                workers):
    """load_gaussians parses a .ply into the host planes it allocates:
    every plane the JAX loader's bit for bit, the colours quantised as
    quantise_colours_u8 quantises JAX's plane (an SH scene's a block at a
    time, an RGB scene's after its /255), and each scene tensor on the
    memory of the plane allocated under its name."""
    props, fmt, late = layout(kind)
    path = write_ply(tmp_path / "scene.ply", props, ROWS, fmt=fmt, late_bright=late)
    monkeypatch.setattr(gaussians_io, "BLOCK_ROWS", BLOCK)
    monkeypatch.setattr(gaussians_io, "MAX_WORKERS", workers)
    degree = 0 if kind == "sh0" else 3
    g = gaussians_io.load_gaussians(path, max_sh_degree=degree, compact_colours=compact,
                                    device="cpu")
    want = jax_ply.load_ply_gaussians(path, max_sh_degree=degree)
    for name, i in SCENE_PLANES.items():
        plane = getattr(g, name).numpy()
        expect = _levels(want[i]) if name == "colours" and compact else want[i]
        assert plane.dtype == expect.dtype and plane.shape == expect.shape, name
        np.testing.assert_array_equal(plane, expect)
        if name == "colours" and compact:
            np.testing.assert_array_equal(plane, gaussians_io.quantise_colours_u8(want[i]))
        assert np.shares_memory(plane, handover[name]), name
    assert g.shs is None and list(handover) == ["xyz", "opacities", "colours", "log_scales",
                                                "rots"]
    assert parse_lines == ["[gs2pc_torch] ply parse: blocks reader, "
                           f"{-(-ROWS // BLOCK)} blocks, f_rest skipped"]


def test_parse_into_lent_planes_with_shs(tmp_path, monkeypatch, handover):
    """with_shs the SH plane is allocated and the scene's shs is on it."""
    path = write_ply(tmp_path / "scene.ply", layout("inria_sh3")[0], ROWS)
    monkeypatch.setattr(gaussians_io, "BLOCK_ROWS", BLOCK)
    g = gaussians_io.load_gaussians(path, with_shs=True, compact_colours=True, device="cpu")
    np.testing.assert_array_equal(g.shs.numpy(), jax_ply.load_ply_gaussians(path)[5])
    assert np.shares_memory(g.shs.numpy(), handover["shs"])
    assert list(handover) == ["xyz", "opacities", "colours", "shs", "log_scales", "rots"]


def test_splat_planes_are_copied(tmp_path, parse_lines, handover):
    """A .splat scene's planes, which its parser makes, are copied into the
    host planes load_gaussians allocates, the colours quantised there; the
    scene tensors are on those planes, and no log line is written."""
    from gs2pc_torch.io.splat import load_splat_gaussians, save_splat

    r = np.random.default_rng(9)
    xyz = r.normal(size=(ROWS, 3)).astype(np.float32)
    rots = r.normal(size=(ROWS, 4)).astype(np.float32)
    save_splat(str(tmp_path / "scene.splat"), xyz, r.normal(size=(ROWS, 3)).astype(np.float32),
               rots / np.linalg.norm(rots, axis=1, keepdims=True),
               r.uniform(size=(ROWS, 3)).astype(np.float32),
               r.uniform(size=ROWS).astype(np.float32))
    path = str(tmp_path / "scene.splat")
    g = gaussians_io.load_gaussians(path, compact_colours=True, device="cpu")
    want = load_splat_gaussians(path)
    np.testing.assert_array_equal(g.colours.numpy(), _levels(want[3]))
    for name, i in SCENE_PLANES.items():
        if name != "colours":
            np.testing.assert_array_equal(getattr(g, name).numpy(), want[i])
        assert np.shares_memory(getattr(g, name).numpy(), handover[name]), name
    assert list(handover) == ["xyz", "opacities", "colours", "log_scales", "rots"]
    assert parse_lines == []
