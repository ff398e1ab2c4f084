"""Build and load the package's native code: the CUDA kernels
(gs2pc_torch/csrc/*.cu, ``nvcc``) and the host libraries, the PLY
expand-writer (gs2pc_torch/csrc/plyio.cpp) and the marching-tetrahedra
mesher (gs2pc_torch/csrc/mesher.cpp), each built with ``g++``.

Each is compiled on first use into a shared library with a plain C
interface under ``build/gs2pc_torch/`` of the checkout (named by a hash of
its sources and flags, so an edited source is rebuilt) and loaded with
``ctypes``.  Nothing here runs at import time: a machine without ``nvcc``
or a card imports the package and uses the PyTorch twins on CPU tensors.
The kernels have no fallback: a failed ``nvcc`` build raises.  The host
libraries have one: without ``g++``, or when a build fails, ``load_plyio``
/ ``load_mesher`` return None and numpy does the work
(gs2pc_torch.io.ply, gs2pc_torch.meshing_native).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build", "gs2pc_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LOCK = threading.Lock()
_LIB = None
# The loaded kernel library's path and the compiler's register /
# shared-memory report ("" when the library was already built).
BUILD_INFO: dict = {}
# Each host library's path, or the reason it is not loaded.
PLYIO_INFO: dict = {}
MESHER_INFO: dict = {}
# Host libraries by source: the loaded library, or None once a load failed.
_HOST_LIBS: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gs2pc_count_pairs": (_I, [_P, _P, _P, _P, _P, _I, _I, _P, _P]),
    "gs2pc_write_pairs": (
        _I, [_P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _P, _P, _P],
    ),
    # keys, values, n, end_bit, scratch, scratch bytes, the sorted keys' and
    # values' pointers (out), the stream.
    "gs2pc_sort_pairs": (
        _I, [_P, _P, ctypes.c_longlong, _I, _P, ctypes.c_ulonglong, ctypes.POINTER(_P),
             ctypes.POINTER(_P), _P],
    ),
    "gs2pc_sort_scratch_bytes": (
        _I, [ctypes.c_longlong, _I, ctypes.POINTER(ctypes.c_ulonglong)],
    ),
    "gs2pc_depth_keys": (_I, [_P, _P, _I, _P, _P, _P]),
    "gs2pc_blend_tiles": (
        _I,
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
         _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    ),
    "gs2pc_probe_op": (_I, [_I, _P, _P, _P]),
    "gs2pc_probe_floor": (_I, [_P]),
    "gs2pc_probe_blend": (_I, [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P]),
    "gs2pc_sample_points": (
        _I,
        [_P, _I, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint32,
         ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, _P, _P, _P],
    ),
    "gs2pc_sample_points_layout": (_I, [ctypes.c_longlong, _P, _P, _P]),
    # means, factors, opacities, alive, colours, the camera's six tensors;
    # P, width, height, adaptive, lanes; the eleven outputs; the stream.
    "gs2pc_project_pack": (_I, [_P] * 11 + [_I] * 5 + [_P] * 11 + [_P]),
    # records, rows, offsets (host int32), their count, lo, compact; xyz,
    # colours, log_scales, rots, shs (or NULL); the stream.
    "gs2pc_ply_decode": (_I, [_P, _I, _P, _I, ctypes.c_longlong, _I] + [_P] * 6),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _build(compiler: str, flags: list, sources: list, hashed: list, stem: str):
    """Compile ``sources`` into ``build/gs2pc_torch/<stem>_<hash>.so`` unless
    that file exists.  Returns (path or None on a failed build, the
    compiler's stderr; "" when the library was already built)."""
    h = hashlib.sha1(" ".join(flags).encode())
    for path in sorted(hashed):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, ""
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, *sources], capture_output=True, text=True)
    if proc.returncode != 0:
        return None, f"{os.path.basename(compiler)} failed ({proc.returncode}):\n{proc.stderr}"
    os.replace(tmp, so)
    return so, proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so, log = _build(
            _nvcc(), NVCC_FLAGS, sorted(glob.glob(os.path.join(_CSRC, "*.cu"))),
            glob.glob(os.path.join(_CSRC, "*.cu*")), "libgs2pc_torch",
        )
        if so is None:
            raise RuntimeError(log)
        BUILD_INFO.update(log=log, path=so)
        lib = ctypes.CDLL(so)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def _load_host(source: str, signatures: dict, info: dict):
    """Build (once per source version) and load ``csrc/<source>`` with g++,
    or None when there is no ``g++`` or the build fails (``info`` says
    which); a failed load is not retried."""
    with _LOCK:
        if source in _HOST_LIBS:
            return _HOST_LIBS[source]
        _HOST_LIBS[source] = None
        gxx = shutil.which("g++")
        if gxx is None:
            info.update(error="g++ not found")
            return None
        src = os.path.join(_CSRC, source)
        stem = f"libgs2pc_torch_{os.path.splitext(source)[0]}"
        so, log = _build(gxx, GXX_FLAGS, [src], [src], stem)
        if so is None:
            info.update(error=log)
            return None
        info.update(path=so)
        lib = ctypes.CDLL(so)
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _HOST_LIBS[source] = lib
        return lib


_I64 = ctypes.c_int64
_PLYIO_SIGNATURES = {
    "gs2pc_write_ply_expand": (_I, [
        ctypes.c_char_p,  # path
        _I64,  # total points
        _P,  # points f32 (total, 3)
        _P,  # counts i64 (P,)
        _I64,  # P
        _P,  # colours u8 (P, 3)
        _P,  # normals f32 (P, 3) or NULL
        _I64,  # chunk size
    ]),
    # The chunked session (LazyPointCloud's rows, a chunk at a time).
    "gs2pc_ply_open": (_P, [ctypes.c_char_p, _I64, _I]),  # path, total, normals -> handle
    "gs2pc_ply_write_chunk": (_I, [
        _P,  # handle
        _P,  # points f32 (hi - lo, 3), row lo first
        _I64,  # lo
        _I64,  # hi
        _P,  # offsets i64 (P + 1,): the counts' prefix from 0
        _I64,  # P
        _P,  # colours u8 (P, 3)
        _P,  # normals f32 (P, 3) or NULL
    ]),
    "gs2pc_ply_close": (_I, [_P]),
}
_MESHER_SIGNATURES = {
    "gs2pc_marching_tet": (_I, [
        _P,  # grid f32 (res, res, res)
        _I64,  # res
        ctypes.c_float,  # iso
        ctypes.POINTER(_P),  # context out
        ctypes.POINTER(_I64),  # vertex count out
        ctypes.POINTER(_I64),  # face count out
    ]),
    "gs2pc_marching_tet_fetch": (_I, [_P, _P, _P]),  # context, verts f32, faces i32
}


def load_plyio() -> ctypes.CDLL | None:
    """The PLY expand-writer (csrc/plyio.cpp), or None (PLYIO_INFO says why)."""
    return _load_host("plyio.cpp", _PLYIO_SIGNATURES, PLYIO_INFO)


def load_mesher() -> ctypes.CDLL | None:
    """The marching-tetrahedra mesher (csrc/mesher.cpp), or None
    (MESHER_INFO says why)."""
    return _load_host("mesher.cpp", _MESHER_SIGNATURES, MESHER_INFO)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def launch(entry, t, *args) -> int:
    """Call the C entry point ``entry(*args)`` with ``t``'s device current
    and return its cudaError_t: the runtime launches on the calling
    thread's current device, which must be the device of the stream from
    ``stream_ptr(t)`` (a sweep over several cards walks them from one
    thread)."""
    import torch

    with torch.cuda.device(t.device):
        return entry(*args)
