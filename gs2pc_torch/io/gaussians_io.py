"""Scene loading to one device (counterpart of gs2pc.io.gaussians_io).

The .ply header parse and codec and the .splat loader are the port's
copies of the JAX package's (gs2pc_torch.io.ply, gs2pc_torch.io.splat); the
plane extraction below repeats gs2pc.io.ply.load_ply_gaussians' rules, bit
for bit.  A binary .ply is parsed in blocks of BLOCK_ROWS rows, spread
over a few threads, each block read into its thread's buffer and its
columns taken into every plane from there.  load_gaussians parses into
host planes it allocates (pinned on a card), with the colours quantised as
each block is filled, and once the parse has ended enqueues each plane's
upload.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from numpy.lib.recfunctions import structured_to_unstructured

from gs2pc_torch.io.ply import has_list, read_ply, read_ply_header, scalar_dtype
from gs2pc_torch.io.splat import load_splat_gaussians
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.utils import log

SH_C0 = 0.28209479177387814

# Rows of a binary .ply body parsed at a time: 32,768 rows of the INRIA
# export (62 float properties, 248 B a row) are 8 MB, read into a buffer
# each thread reuses, which every plane takes its columns from.  Threads
# that parse blocks at once: at most one a core the process may run on, and
# at most MAX_WORKERS (numpy's copies and arithmetic and the reads release
# the interpreter lock, so blocks parse side by side).  Both measured on an
# H100 host's 8 cores: the bicycle-size export (6.1M rows) parses in 1.1 s
# on one thread, 0.37 s on eight with these blocks, 0.6-0.8 s on eight
# with blocks of 16,384 or 65,536 rows.
BLOCK_ROWS = 32768
MAX_WORKERS = 8


def _sorted_props(names, prefix):
    return sorted(
        (p for p in names if p.startswith(prefix)), key=lambda x: int(x.split("_")[-1])
    )


def _take(out: np.ndarray, rec: np.ndarray, fields) -> np.ndarray:
    """``out`` (rows, len(fields)) filled with the fields of ``rec``, cast
    to its dtype a column at a time (a copy of a whole row of few fields
    runs an inner loop as short as the row)."""
    for j, f in enumerate(fields):
        out[:, j] = rec[f]
    return out


class _Planes:
    """The scene's planes of a vertex element with the properties ``names``,
    allocated once and filled a run of rows at a time (``fill``) with
    gs2pc.io.ply.load_ply_gaussians' expressions, all elementwise or within
    a row; ``shs`` only ``with_shs`` on an SH scene.

    Every plane comes from ``alloc(name, shape)`` (a float32 array to
    fill); one the file has no fields for is filled here with the JAX
    loader's constant.  With ``compact_colours`` the colours are quantised
    as quantise_colours_u8 does, in place: an SH scene's a block at a time
    in ``fill``, an RGB scene's in ``finish``, after its /255 autodetect."""

    def __init__(self, names, n: int, max_sh_degree: int, with_shs: bool, alloc,
                 compact_colours: bool):
        props = set(names)
        self.sh = "f_dc_0" in props
        if self.sh:
            self.rest = _sorted_props(names, "f_rest_")
            expected = 3 * (max_sh_degree + 1) ** 2 - 3
            if len(self.rest) != expected:
                raise ValueError(
                    f"Expected {expected} f_rest_* properties for sh degree "
                    f"{max_sh_degree}, found {len(self.rest)}"
                )
        elif "red" not in props:
            raise ValueError(
                "Input ply file does not have valid colours (must have either "
                "spherical harmonics or RGB colour fields)"
            )
        self.opacity = "opacity" in props
        self.scale_names = _sorted_props(names, "scale_")
        self.rot_names = _sorted_props(names, "rot")
        self.quantise = compact_colours
        self.xyz = alloc("xyz", (n, 3))
        self.opacities = alloc("opacities", (n,))
        if not self.opacity:
            self.opacities[...] = 1.0
        self.colours = alloc("colours", (n, 3))
        self.shs = alloc("shs", (n, 3, (max_sh_degree + 1) ** 2)) if (
            self.sh and with_shs) else None
        self.log_scales = alloc("log_scales", (n, len(self.scale_names) or 3))
        if not self.scale_names:
            self.log_scales[...] = -8.0
        self.rots = alloc("rots", (n, len(self.rot_names) or 4))
        if not self.rot_names:
            self.rots[...] = (1.0, 0.0, 0.0, 0.0)

    def fill(self, rec: np.ndarray, lo: int, span=log.span) -> None:
        """Rows lo.. of every plane from the records ``rec``: span
        ``ply_columns``, then ``ply_sh_rest`` for the f_rest copy."""
        rows = slice(lo, lo + rec.shape[0])
        with span("ply_columns"):
            _take(self.xyz[rows], rec, ("x", "y", "z"))
            if self.opacity:
                raw = np.asarray(rec["opacity"], np.float32)
                self.opacities[rows] = 1.0 / (1.0 + np.exp(-raw))
            if self.sh:
                f_dc = _take(np.empty((rec.shape[0], 3), np.float32), rec,
                             ("f_dc_0", "f_dc_1", "f_dc_2"))
                colours = np.clip(SH_C0 * f_dc + 0.5, 0.0, 1.0)
                self.colours[rows] = _quantise_u8(colours) if self.quantise else colours
            else:
                _take(self.colours[rows], rec, ("red", "green", "blue"))
            if self.scale_names:
                _take(self.log_scales[rows], rec, self.scale_names)
            if self.rot_names:
                rots = _take(np.empty((rec.shape[0], len(self.rot_names)), np.float32), rec,
                             self.rot_names)
                rots /= np.maximum(np.linalg.norm(rots, axis=1, keepdims=True), 1e-12)
                self.rots[rows] = np.negative(rots, out=rots, where=rots[:, :1] < 0.0)
        if self.shs is not None:
            with span("ply_sh_rest"):
                self.shs[rows, :, 0] = f_dc
                if self.rest:
                    # One strided copy where the f_rest fields lie side by
                    # side (a view of the block); a column at a time, 45
                    # passes over the SH plane's rows, takes eight times as
                    # long.
                    self.shs[rows, :, 1:] = structured_to_unstructured(
                        rec[self.rest]).reshape(rec.shape[0], 3, -1)

    def finish(self) -> None:
        """What is decided over the whole plane: the RGB /255 autodetect,
        then an RGB scene's quantise; both in place."""
        if self.sh:
            return
        if (self.colours > 1.0).any():
            np.clip(np.divide(self.colours, 255.0, out=self.colours), 0.0, 1.0, out=self.colours)
        if self.quantise:
            _quantise_u8(self.colours)


def _untimed(name: str):
    return contextlib.nullcontext()


def _pread_full(fd: int, view: memoryview, offset: int) -> int:
    got = 0
    while got < len(view):
        k = os.preadv(fd, [view[got:]], offset + got)
        if not k:
            break
        got += k
    return got


def _parse_blocks(path: str, body: int, dtype: np.dtype, n: int, planes: _Planes) -> int:
    """Fill ``planes`` from the ``n`` records of ``dtype`` at byte ``body``
    of ``path``, BLOCK_ROWS at a time; returns the blocks read.  Block k
    goes to thread k mod T, T = min(cores, MAX_WORKERS, blocks); thread 0
    is the caller, and only its blocks open spans (``ply_read`` the read,
    then fill's), so the spans split the pass's wall as its share of the
    blocks splits it, while the other threads run the same work alongside.
    Waiting for them is ``ply_columns``."""
    starts = range(0, n, BLOCK_ROWS)
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    workers = max(1, min(cores or 1, MAX_WORKERS, len(starts)))
    fd = os.open(path, os.O_RDONLY)

    def run(k: int) -> None:
        span = log.span if k == 0 else _untimed
        buf = np.empty(min(BLOCK_ROWS, n) * dtype.itemsize, np.uint8)
        for lo in starts[k::workers]:
            size = min(BLOCK_ROWS, n - lo) * dtype.itemsize
            with span("ply_read"):
                got = _pread_full(fd, memoryview(buf)[:size], body + lo * dtype.itemsize)
            if got < size:
                raise ValueError(f"{path}: the body ends at row {lo + got // dtype.itemsize}"
                                 f" of the {n} its header gives")
            planes.fill(buf[:size].view(dtype), lo, span)

    try:
        if workers == 1:
            run(0)
        else:
            with ThreadPoolExecutor(workers - 1, thread_name_prefix="gs2pc_ply") as pool:
                others = [pool.submit(run, k) for k in range(1, workers)]
                run(0)
                with log.span("ply_columns"):
                    for done in others:
                        done.result()
    finally:
        os.close(fd)
    return len(starts)


def load_ply_gaussians(path: str, max_sh_degree: int = 3, with_shs: bool = True,
                       alloc=None, compact_colours: bool = False):
    """3DGS .ply -> host arrays (xyz, log_scales, rots, colours, opacities,
    shs), with the same rules as gs2pc.io.ply.load_ply_gaussians: sigmoid
    opacities, degree-0 SH colours (or RGB with /255 autodetect), unit
    quaternions sign-normalised to w >= 0, and the full SH coefficients
    (P, 3, (max_sh_degree + 1)^2) of an SH scene (None for RGB colours, or
    without ``with_shs``): f_dc first, then the f_rest_j sorted by their
    number, channel-major.

    A binary vertex element of scalar properties (the "blocks" reader) is
    read BLOCK_ROWS rows at a time, by a few threads (_parse_blocks), each
    block viewed with the element's record dtype and every plane taking its
    rows from it; an ascii file or an element with list properties is read
    whole by read_ply (the "records" reader) and filled the same way in one
    go.
    One log line says which reader ran, the blocks read and whether f_rest
    was copied.

    Every plane returned is the float32 array ``alloc(name, shape)`` gave
    (np.empty by default), asked for in the JAX package's order and with its
    names: xyz, opacities, colours, shs (when taken), log_scales, rots.
    With ``compact_colours`` the colours come quantised as
    quantise_colours_u8 quantises them (_Planes).

    Spans (utils.log.span), which do not overlap: ``ply_read`` the header
    and the reads, ``ply_columns`` every plane but shs and the RGB /255
    decision, ``ply_sh_rest`` the f_dc and f_rest copy into ``shs``
    (entered, empty, when no shs is made); of the blocks, those of the
    calling thread."""
    with log.span("ply_read"):
        with open(path, "rb") as fh:
            fmt, elements = read_ply_header(fh, path)
            body = fh.tell()
    vertex = elements[0]
    planes = _Planes(vertex.property_names, vertex.count, max_sh_degree, with_shs,
                     alloc or (lambda name, shape: np.empty(shape, np.float32)), compact_colours)
    blocked = fmt != "ascii" and not has_list(vertex)
    if blocked:
        n_blocks = _parse_blocks(path, body, scalar_dtype(vertex, fmt), vertex.count, planes)
    else:
        with log.span("ply_read"):
            records = next(iter(read_ply(path).values())).data
        planes.fill(records, 0)
        n_blocks = 0
    if planes.shs is None:
        with log.span("ply_sh_rest"):
            pass
    log.info(f"[gs2pc_torch] ply parse: {'blocks' if blocked else 'records'} reader, "
             f"{n_blocks} blocks, f_rest {'copied' if planes.shs is not None else 'skipped'}")

    with log.span("ply_columns"):
        planes.finish()
    return (planes.xyz, planes.log_scales, planes.rots, planes.colours, planes.opacities,
            planes.shs)


def _quantise_u8(c: np.ndarray) -> np.ndarray:
    """quantise_colours_u8 of the float32 array ``c``, in place; returns ``c``."""
    np.clip(c, 0.0, 1.0, out=c)
    np.round(np.multiply(c, np.float32(255.0), out=c), out=c)
    c[...] = c.astype(np.uint8)
    return np.multiply(c, np.float32(1.0 / 255.0), out=c)


def quantise_colours_u8(colours: np.ndarray) -> np.ndarray:
    """Round-to-nearest 8-bit colours, returned as float32 k * (1/255) (the
    value the compact blend table decodes, and the JAX loader's): the exact
    quantisation the compact blend table applies (rasterize.pack_blend_table)."""
    return _quantise_u8(colours.astype(np.float32))


class _HostPlanes:
    """The ``alloc`` of a load onto ``device``: float32 host planes, on a
    card pinned memory from torch's caching host allocator (whose blocks
    come back pinned and faulted in from one conversion to the next), each
    kept by name as the tensor its upload starts from: the allocator holds a
    block back until its copy has finished only for a tensor it handed out,
    not for one made again from the array."""

    def __init__(self, device: torch.device):
        self.pin = device.type == "cuda"
        self.tensors: dict = {}

    def __call__(self, name: str, shape) -> np.ndarray:
        plane = torch.empty(shape, dtype=torch.float32, pin_memory=self.pin)
        self.tensors[name] = plane
        return plane.numpy()


def load_gaussians(
    input_path: str, max_sh_degree: int = 3, compact_colours: bool = False,
    with_shs: bool = False, *, device
) -> Gaussians:
    """Load a .ply or .splat scene onto ``device``.

    With ``compact_colours`` the colour plane is quantised to 8 bits per
    channel before the upload, as in the JAX loader.  The SH coefficients
    of an SH scene are uploaded only ``with_shs`` (--sh_colour_eval): a
    degree-3 scene of 3M Gaussians carries 576 MB of them.

    The scene is parsed into host planes allocated here (_HostPlanes): a
    .ply by load_ply_gaussians, a .splat by load_splat_gaussians and then
    copied in.  Each plane's upload is then enqueued on the current stream
    (non-blocking from pinned memory on a card; off a card the tensor is
    the plane itself), which orders it before every later use, and torch's
    host allocator reuses no pinned block before its copy has finished.
    The span ``plane_upload`` times the enqueues, and a .splat's copy into
    its planes."""
    ext = os.path.splitext(input_path)[1]
    if ext not in (".splat", ".ply"):
        raise ValueError(f"Unsupported input type {ext}")
    device = torch.device(device)
    host = _HostPlanes(device)
    with log.phase("scene_parse"):
        if ext == ".splat":
            xyz, log_scales, rots, colours, opacities, _ = load_splat_gaussians(input_path)
            with log.span("plane_upload"):
                for name, array in (("xyz", xyz), ("opacities", opacities),
                                    ("colours", colours), ("log_scales", log_scales),
                                    ("rots", rots)):
                    host(name, array.shape)[...] = array
                if compact_colours:
                    _quantise_u8(host.tensors["colours"].numpy())
        else:
            load_ply_gaussians(input_path, max_sh_degree=max_sh_degree, with_shs=with_shs,
                               alloc=host, compact_colours=compact_colours)
        with log.span("plane_upload"):
            p = {name: plane.to(device, non_blocking=True)
                 for name, plane in host.tensors.items()}
    with log.phase("scene_upload"):
        return Gaussians(
            xyz=p["xyz"], log_scales=p["log_scales"], rots=p["rots"],
            opacities=p["opacities"].reshape(-1), colours=p["colours"], shs=p.get("shs"),
            normals=None, keep_mask=torch.ones(p["xyz"].shape[0], dtype=torch.bool,
                                               device=device),
        )
