"""Build and load the package's CUDA kernels (gs2pc_torch/csrc/*.cu).

The sources are compiled on first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, under ``build/gs2pc_torch/`` of
the checkout (named by a hash of the sources, so an edited kernel is
rebuilt), and loaded with ``ctypes``.  Nothing here runs at import time:
a machine without ``nvcc`` or a card imports the package and uses the
PyTorch twins on CPU tensors.
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

_LOCK = threading.Lock()
_LIB = None
# The loaded library's path and the compiler's register / shared-memory
# report ("" when the library was already built).
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gs2pc_count_pairs": (_I, [_P, _P, _P, _P, _P, _I, _I, _P, _P]),
    "gs2pc_write_pairs": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]),
    "gs2pc_blend_tiles": (
        _I,
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
         _P, _P, _P, _P, _P, _P, _P, _P],
    ),
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


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so = os.path.join(_BUILD_DIR, f"libgs2pc_torch_{_digest()}.so")
        log = ""
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            log = proc.stderr
            os.replace(tmp, so)
        BUILD_INFO.update(log=log, path=so)
        lib = ctypes.CDLL(so)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
