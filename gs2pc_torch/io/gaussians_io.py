"""Scene loading to one device (counterpart of gs2pc.io.gaussians_io).

The .ply header parse and codec and the .splat loader are the port's
copies of the JAX package's (gs2pc_torch.io.ply, gs2pc_torch.io.splat); the
plane extraction below repeats gs2pc.io.ply.load_ply_gaussians' rules, bit
for bit.  A binary .ply is parsed in blocks of BLOCK_ROWS rows, spread
over a few threads, each block read into its thread's buffer and its
columns taken into every plane from there.  load_gaussians parses into
host planes it allocates (pinned on a card), with the colours quantised as
each block is filled, and once the parse has ended enqueues each plane's
upload.  On a card, an export whose records the decode kernel takes (a
3DGS export of float32 fields, _card_layout) is decoded there instead: the
threads read each block into pinned memory, take its opacities on the host
and copy it over, and ops.plydecode fills every other plane on the card.
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
from gs2pc_torch.ops import plydecode
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
# Rows of a block the card decodes (_decode_blocks).  Each block costs its
# thread a read, the opacities, a copy and a launch, and the threads
# contend for the interpreter and the CUDA driver on the Python and CUDA
# calls, so blocks larger than the host parse's pay.  Measured on an H100
# host's 8 cores, the bicycle-size export (6.1M rows, 1.51 GB) in seven
# interleaved rounds: 0.192 s with blocks of 32,768 rows, 0.166 s with
# 49,152, 0.152 s with 65,536 (the host parse: 0.492 s).  Each thread keeps
# a block of device staging: 61,440 rows hold it under 128 MB (8 x 61,440
# x 248 B = 122 MB).
CARD_BLOCK_ROWS = 61440


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
                self.opacities[rows] = _sigmoid(rec["opacity"])
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


def _sigmoid(raw: np.ndarray) -> np.ndarray:
    """The opacities of the raw ``opacity`` field, in float32."""
    raw = np.asarray(raw, np.float32)
    return 1.0 / (1.0 + np.exp(-raw))


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


def _read_block(fd: int, view, path: str, body: int, lo: int, n: int, itemsize: int) -> None:
    """Read rows lo.. of the ``n`` records of ``itemsize`` bytes at byte
    ``body`` of ``path`` into ``view`` (as many as it holds)."""
    got = _pread_full(fd, memoryview(view), body + lo * itemsize)
    if got < len(view):
        raise ValueError(f"{path}: the body ends at row {lo + got // itemsize}"
                         f" of the {n} its header gives")


def _workers(n_blocks: int) -> int:
    """Threads for ``n_blocks`` blocks: min(cores, MAX_WORKERS, blocks)."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return max(1, min(cores or 1, MAX_WORKERS, n_blocks))


def _spread(workers: int, run) -> None:
    """run(k) for k < workers: run(0) on the calling thread, the others on
    a pool alongside; waiting for them is ``ply_columns``."""
    if workers == 1:
        run(0)
        return
    with ThreadPoolExecutor(workers - 1, thread_name_prefix="gs2pc_ply") as pool:
        others = [pool.submit(run, k) for k in range(1, workers)]
        run(0)
        with log.span("ply_columns"):
            for done in others:
                done.result()


def _parse_blocks(path: str, body: int, dtype: np.dtype, n: int, planes: _Planes) -> int:
    """Fill ``planes`` from the ``n`` records of ``dtype`` at byte ``body``
    of ``path``, BLOCK_ROWS at a time; returns the blocks read.  Block k
    goes to thread k mod T, T = _workers(blocks); thread 0 is the caller,
    and only its blocks open spans (``ply_read`` the read, then fill's), so
    the spans split the pass's wall as its share of the blocks splits it,
    while the other threads run the same work alongside.  Waiting for them
    is ``ply_columns``."""
    starts = range(0, n, BLOCK_ROWS)
    workers = _workers(len(starts))
    fd = os.open(path, os.O_RDONLY)

    def run(k: int) -> None:
        span = log.span if k == 0 else _untimed
        buf = np.empty(min(BLOCK_ROWS, n) * dtype.itemsize, np.uint8)
        for lo in starts[k::workers]:
            size = min(BLOCK_ROWS, n - lo) * dtype.itemsize
            with span("ply_read"):
                _read_block(fd, buf[:size], path, body, lo, n, dtype.itemsize)
            planes.fill(buf[:size].view(dtype), lo, span)

    try:
        _spread(workers, run)
    finally:
        os.close(fd)
    return len(starts)


def _card_layout(fmt: str, vertex, max_sh_degree: int):
    """The decode's ops.plydecode.RecordLayout of ``vertex`` when a card
    takes its records, else None: binary little-endian, every property a
    scalar float32, x y z, f_dc_0..2 and opacity among them, scale_0..2 and
    rot_0..3 just those (as _Planes sorts them), and the f_rest_* count
    ``max_sh_degree`` gives, at most plydecode.MAX_REST.  Every other
    layout (ascii, lists, RGB colours with their /255 decided over the whole
    plane, doubles, fields filled with constants) takes the host path."""
    names = vertex.property_names
    if fmt != "binary_little_endian" or any(t != "f4" for _, t in vertex.properties):
        return None
    if not {"x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity"} <= set(names):
        return None
    scales, rots = _sorted_props(names, "scale_"), _sorted_props(names, "rot")
    if scales != [f"scale_{c}" for c in range(3)] or rots != [f"rot_{c}" for c in range(4)]:
        return None
    rest = _sorted_props(names, "f_rest_")
    if len(rest) != 3 * (max_sh_degree + 1) ** 2 - 3 or len(rest) > plydecode.MAX_REST:
        return None
    dtype = scalar_dtype(vertex, fmt)
    fields = ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"] + scales + rots
    return plydecode.RecordLayout(dtype.itemsize, tuple(dtype.fields[f][1] for f in fields),
                                  tuple(dtype.fields[f][1] for f in rest))


def _decode_blocks(path: str, body: int, dtype: np.dtype, n: int,
                   layout: "plydecode.RecordLayout", planes: dict, opacities: np.ndarray,
                   compact: bool) -> int:
    """Fill the device planes ``planes`` (xyz, colours, [shs], log_scales,
    rots) and the host plane ``opacities`` from the ``n`` records of
    ``dtype`` at byte ``body`` of ``path``, CARD_BLOCK_ROWS at a time, over
    _parse_blocks' threads; returns the blocks read.  Each thread reads its
    blocks into two staging buffers in turn (pinned, from torch's caching
    host allocator, on a card), reusing one only once its last copy has
    ended; it computes the block's opacities (the host path's expression:
    numpy's float32 exp, which no card function repeats bit for bit), then
    on a stream of its own copies the block into its device staging and
    launches ply_decode there.  The current stream waits for every
    thread's stream before the staging is freed.  Spans as _parse_blocks':
    ``ply_read`` the reads, ``ply_columns`` the opacities, the copy and the
    launch, and the wait for the other threads.  Off a card (the tests) the
    same steps run on CPU tensors, and ply_decode runs its twin."""
    starts = range(0, n, CARD_BLOCK_ROWS)
    workers = _workers(len(starts))
    block = min(CARD_BLOCK_ROWS, n) * dtype.itemsize
    device = planes["xyz"].device
    cuda = device.type == "cuda"
    staging = torch.empty((workers, block), dtype=torch.uint8, device=device)
    streams = [torch.cuda.Stream(device) if cuda else None for _ in range(workers)]
    fd = os.open(path, os.O_RDONLY)

    def run(k: int) -> None:
        span = log.span if k == 0 else _untimed
        bufs = [torch.empty(block, dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        copied = [torch.cuda.Event() for _ in bufs] if cuda else None
        with torch.cuda.stream(streams[k]) if cuda else contextlib.nullcontext():
            for i, lo in enumerate(starts[k::workers]):
                rows = min(CARD_BLOCK_ROWS, n - lo)
                size = rows * dtype.itemsize
                buf = bufs[i % 2][:size]
                host = buf.numpy()
                if cuda:
                    copied[i % 2].synchronize()
                with span("ply_read"):
                    _read_block(fd, host, path, body, lo, n, dtype.itemsize)
                with span("ply_columns"):
                    opacities[lo:lo + rows] = _sigmoid(host.view(dtype)["opacity"])
                    staging[k, :size].copy_(buf, non_blocking=True)
                    if cuda:
                        copied[i % 2].record()
                    plydecode.ply_decode(staging[k], rows, lo, layout, planes, compact)

    try:
        _spread(workers, run)
    finally:
        os.close(fd)
        if cuda:
            for stream in streams:
                torch.cuda.current_stream(device).wait_stream(stream)
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
    return _parse_on_host(path, *_read_header(path), max_sh_degree, with_shs,
                          alloc or (lambda name, shape: np.empty(shape, np.float32)),
                          compact_colours)


def _read_header(path: str):
    """(format, vertex element, byte offset of the body) of the .ply at
    ``path``; span ``ply_read``."""
    with log.span("ply_read"):
        with open(path, "rb") as fh:
            fmt, elements = read_ply_header(fh, path)
            return fmt, elements[0], fh.tell()


def _parse_on_host(path: str, fmt: str, vertex, body: int, max_sh_degree: int, with_shs: bool,
                   alloc, compact_colours: bool):
    """load_ply_gaussians after its header."""
    planes = _Planes(vertex.property_names, vertex.count, max_sh_degree, with_shs, alloc,
                     compact_colours)
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


def _decode_on_card(path: str, fmt: str, vertex, body: int, layout, with_shs: bool,
                    compact_colours: bool, alloc, device: torch.device) -> dict:
    """The planes of an export that _card_layout takes, decoded on
    ``device`` (_decode_blocks), by name: xyz, colours, shs (only
    ``with_shs``), log_scales, rots, allocated there in that order; the
    opacities go into ``alloc("opacities", (n,))``.  Spans and log line as
    load_ply_gaussians' (the reader "blocks_card"); ``ply_sh_rest`` is
    entered once, empty, the kernel copying the SH coefficients."""
    n = vertex.count
    opacities = alloc("opacities", (n,))
    f32 = dict(dtype=torch.float32, device=device)
    planes = {"xyz": torch.empty((n, 3), **f32), "colours": torch.empty((n, 3), **f32)}
    if with_shs:
        planes["shs"] = torch.empty((n, 3, len(layout.rest) // 3 + 1), **f32)
    planes["log_scales"] = torch.empty((n, 3), **f32)
    planes["rots"] = torch.empty((n, 4), **f32)
    n_blocks = _decode_blocks(path, body, scalar_dtype(vertex, fmt), n, layout, planes,
                              opacities, compact_colours)
    with log.span("ply_sh_rest"):
        pass
    log.info(f"[gs2pc_torch] ply parse: blocks_card reader, {n_blocks} blocks, "
             f"f_rest {'copied' if with_shs else 'skipped'}")
    return planes


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
    .ply as load_ply_gaussians parses it, a .splat by load_splat_gaussians
    and then copied in.  Each plane's upload is then enqueued on the current
    stream (non-blocking from pinned memory on a card; off a card the tensor
    is the plane itself), which orders it before every later use, and
    torch's host allocator reuses no pinned block before its copy has
    finished.  The span ``plane_upload`` times the enqueues, and a .splat's
    copy into its planes.  On a card a .ply whose header _card_layout takes
    is decoded there (_decode_on_card), bit for bit as the host parse
    would fill its planes: only its opacities pass through a host plane."""
    ext = os.path.splitext(input_path)[1]
    if ext not in (".splat", ".ply"):
        raise ValueError(f"Unsupported input type {ext}")
    device = torch.device(device)
    host = _HostPlanes(device)
    decoded: dict = {}
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
            fmt, vertex, body = _read_header(input_path)
            layout = _card_layout(fmt, vertex, max_sh_degree) if device.type == "cuda" else None
            if layout is None:
                _parse_on_host(input_path, fmt, vertex, body, max_sh_degree, with_shs, host,
                               compact_colours)
            else:
                decoded = _decode_on_card(input_path, fmt, vertex, body, layout, with_shs,
                                          compact_colours, host, device)
        with log.span("plane_upload"):
            p = {name: plane.to(device, non_blocking=True)
                 for name, plane in host.tensors.items()}
        p.update(decoded)
    with log.phase("scene_upload"):
        return Gaussians(
            xyz=p["xyz"], log_scales=p["log_scales"], rots=p["rots"],
            opacities=p["opacities"].reshape(-1), colours=p["colours"], shs=p.get("shs"),
            normals=None, keep_mask=torch.ones(p["xyz"].shape[0], dtype=torch.bool,
                                               device=device),
        )
