"""The scene load's record decode on a card (csrc/plydecode.cu) and its
PyTorch twin.

``ply_decode`` takes a block of raw vertex records of a binary
little-endian 3DGS export (float32 fields: x y z, f_dc_0..2, scale_0..2,
rot_0..3, any others skipped, f_rest_* copied only into an SH plane) and
writes its rows into the planes xyz, colours, log_scales, rots and, when
given, shs, with gs2pc_torch.io.gaussians_io._Planes.fill's expressions bit
for bit (the opacity is not taken: its numpy exp stays on the host).  The
kernel on CUDA tensors, ``ply_decode_torch`` on CPU tensors; the twin
writes every float operation out with the NaN results an x86-64 host's SSE
gives, which the kernel repeats (csrc/plydecode.cu says how).

Which exports take it is the loader's choice, made from the header
(gaussians_io._card_layout).
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from gs2pc_torch.ops.sh import SH_C0

# f_rest_* fields a record may have (csrc/plydecode.cu's PLY_MAX_REST):
# degree 3, the most 3DGS exports.
MAX_REST = 45

_C0 = torch.tensor(np.float32(SH_C0))
_EPS = torch.tensor(np.float32(1e-12))
_INV255 = torch.tensor(np.float32(1.0 / 255.0))
_ZERO = torch.tensor(0.0)
_DEFAULT_NAN = torch.tensor(np.uint32(0xFFC00000).view(np.int32)).view(torch.float32)
_QUIET = 0x00400000
_SIGN = -0x80000000
# The load's threads launch side by side: the launch count's update is
# theirs to share.
_LAUNCHES_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class RecordLayout:
    """Byte offsets in a record of ``stride`` bytes: ``fields`` x y z,
    f_dc_0..2, scale_0..2, rot_0..3; ``rest`` the f_rest_* fields in the
    order of their numbers."""

    stride: int
    fields: tuple
    rest: tuple

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        """The C entry point's offsets: stride, fields, rest."""
        return np.array((self.stride,) + self.fields + self.rest, np.int32)


def ply_decode(records: torch.Tensor, rows: int, lo: int, layout: RecordLayout, planes: dict,
               compact: bool) -> None:
    """Rows lo..lo + rows of the float32 planes ``planes["xyz"]`` (P, 3),
    ``"colours"`` (P, 3), ``"log_scales"`` (P, 3), ``"rots"`` (P, 4) and,
    unless it is None or missing, ``"shs"`` (P, 3, len(rest) / 3 + 1; other
    planes in the dict are left alone), from the
    first ``rows`` records of the uint8 tensor ``records``; the colours
    quantised as quantise_colours_u8 does when ``compact``.  One kernel
    launch on the current stream (counted in ``ply_decode.launches``) on
    CUDA tensors, the twin on CPU tensors."""
    dev = records.device
    if dev.type == "cpu":
        return ply_decode_torch(records, rows, lo, layout, planes, compact)
    from gs2pc_torch.ops.cuda_build import check, launch, load_library, stream_ptr

    shs = planes.get("shs")
    P = planes["xyz"].shape[0]
    shapes = {"xyz": (P, 3), "colours": (P, 3), "log_scales": (P, 3), "rots": (P, 4)}
    if shs is not None:
        shapes["shs"] = (P, 3, len(layout.rest) // 3 + 1)
    if (records.dtype != torch.uint8 or not records.is_contiguous()
            or records.numel() < rows * layout.stride or not 0 <= lo <= P - rows
            or len(layout.rest) > MAX_REST
            or any(planes[name].dtype != torch.float32 or planes[name].device != dev
                   or not planes[name].is_contiguous() or tuple(planes[name].shape) != shape
                   for name, shape in shapes.items())):
        raise ValueError("ply_decode: contiguous uint8 records of the rows and float32 planes "
                         "xyz, colours, log_scales (P, 3), rots (P, 4), shs (P, 3, K) on one "
                         "card, rows lo.. inside them")
    offsets = layout.offsets
    rc = launch(
        load_library().gs2pc_ply_decode, records, records.data_ptr(), rows,
        offsets.ctypes.data, offsets.size, lo, int(compact), planes["xyz"].data_ptr(),
        planes["colours"].data_ptr(), planes["log_scales"].data_ptr(),
        planes["rots"].data_ptr(), shs.data_ptr() if shs is not None else None,
        stream_ptr(records),
    )
    with _LAUNCHES_LOCK:
        ply_decode.launches += 1
    check(rc, "gs2pc_ply_decode")


# Kernel launches (one a block); a caller resets it (= 0).
ply_decode.launches = 0


def ply_decode_torch(records: torch.Tensor, rows: int, lo: int, layout: RecordLayout,
                     planes: dict, compact: bool) -> None:
    """ply_decode's twin on CPU tensors: the kernel's operations in its
    order, each float result as SSE gives it (_sse)."""
    rec = records[: rows * layout.stride].view(rows, layout.stride)

    def take(offsets):
        return torch.stack([rec[:, o:o + 4].contiguous().view(torch.float32)[:, 0]
                            for o in offsets], 1)

    out = slice(lo, lo + rows)
    planes["xyz"][out] = take(layout.fields[0:3])
    planes["log_scales"][out] = take(layout.fields[6:9])
    f_dc = take(layout.fields[3:6])
    colours = _clip01(_add(_mul(_C0, f_dc), torch.tensor(0.5)))
    if compact:
        t = torch.round(_mul(colours, torch.tensor(255.0)))
        q = torch.where(torch.isnan(t), 0.0, t).to(torch.uint8)
        colours = _mul(q.to(torch.float32), _INV255)
    planes["colours"][out] = colours
    r = take(layout.fields[9:13])
    sq = [_mul(r[:, j], r[:, j]) for j in range(4)]
    norm = _root(_add(_add(_add(sq[0], sq[1]), sq[2]), sq[3]))
    norm = torch.where(torch.isnan(norm) | (norm >= _EPS), norm, _EPS)[:, None]
    r = _sse(r, norm, r / norm)
    flipped = (r.view(torch.int32) ^ _SIGN).view(torch.float32)
    planes["rots"][out] = torch.where(r[:, :1] < 0.0, flipped, r)
    if planes.get("shs") is not None:
        per = len(layout.rest) // 3
        shs = planes["shs"][out]
        shs[:, :, 0] = f_dc
        if per:
            shs[:, :, 1:] = take(layout.rest).view(rows, 3, per)


def _quiet(a: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) | _QUIET).view(torch.float32)


def _sse(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The result ``r`` of a op b as SSE gives it: a NaN operand quieted,
    ``a`` before ``b``; the default NaN for an invalid operation."""
    r = torch.where(torch.isnan(r), _DEFAULT_NAN, r)
    r = torch.where(torch.isnan(b), _quiet(b), r)
    return torch.where(torch.isnan(a), _quiet(a), r)


def _mul(a, b):
    return _sse(a, b, a * b)


def _add(a, b):
    return _sse(a, b, a + b)


def _root(a):
    # torch.sqrt of float32 on the CPU need not be correctly rounded; the
    # square root in float64, rounded to float32, is.
    return _sse(a, _ZERO, torch.sqrt(a.double()).float())


def _clip01(v):
    """np.clip(v, 0.0, 1.0): min(max(v, 0), 1), a NaN passed through."""
    v = torch.where(torch.isnan(v) | (v > 0.0), v, 0.0)
    return torch.where(torch.isnan(v) | (v < 1.0), v, 1.0)
