"""gs2pc_torch -- the conversion of gs2pc ported to PyTorch and CUDA on one
NVIDIA GPU (H100, sm_90a).

Module names mirror ``gs2pc/``, which stays the JAX reference that every
module here is tested against.  The package imports ``torch`` and never
JAX.  Every function takes an explicit device (or works on the tensors'
own); nothing picks a device by itself.  The hand-written kernels live in
``csrc/`` and are built on first use (``ops/cuda_build.py``); each has a
plain PyTorch twin in the same module, which runs for CPU tensors only.
"""

from gs2pc.version import __version__

__all__ = ["__version__"]
