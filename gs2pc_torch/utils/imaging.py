"""Image output (counterpart of gs2pc.utils.imaging, parity:
gauss_to_pc.py:67-71 imwrite), as 8-bit PNG written and read with the
standard library alone (zlib, struct): no imageio and no PIL."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types: grey and RGB, 8 bits a sample.
_COLOUR_TYPES = {1: 0, 3: 2}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def to_u8(image) -> np.ndarray:
    """The JAX package's quantisation: clip to [0, 1], x 255, truncated to u8."""
    return (255.0 * np.clip(np.asarray(image), 0.0, 1.0)).astype(np.uint8)


def write_png(path: str, arr: np.ndarray) -> None:
    """An (H, W) grey or (H, W, 3) RGB uint8 array as a PNG, every row with
    filter 0 (none)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {arr.dtype}")
    channels = 1 if arr.ndim == 2 else arr.shape[2] if arr.ndim == 3 else 0
    if channels not in _COLOUR_TYPES:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), not {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * channels)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPES[channels], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def imwrite(path: str, image) -> None:
    """Clip a [0, 1] float image (H, W) or (H, W, 3) to uint8 and save it as PNG."""
    write_png(path, to_u8(image))


def imread_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced grey or RGB PNG whose rows use filter
    0, as ``write_png`` writes it: (H, W) or (H, W, 3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != zlib.crc32(
                kind + body):
            raise ValueError(f"{path}: {kind!r} chunk fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    channels = {v: k for k, v in _COLOUR_TYPES.items()}.get(colour)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit grey or RGB without interlace is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters other than 0")
    img = rows[:, 1:].reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img.copy()
