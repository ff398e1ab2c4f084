"""Quiet-gated logging + phase timing (the PyTorch counterpart of
gs2pc.utils.log, with the same ``phase()``/``PHASE_SECONDS`` API).

Phases are annotated with ``torch.profiler.record_function`` so a profiler
trace shows them, and a phase that ran CUDA work ends with a device
synchronise: PyTorch returns before the card finishes, so without it the
wall-clock of a phase would measure the enqueue, not the work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

_QUIET = False


def set_quiet(quiet: bool) -> None:
    global _QUIET
    _QUIET = quiet


def info(msg: str = "") -> None:
    if not _QUIET:
        print(msg, flush=True)


def warn(msg: str) -> None:
    print(f"WARNING: {msg}", flush=True)


# Accumulated wall-clock per phase name since the last reset_phases().
PHASE_SECONDS: dict[str, float] = {}


def reset_phases() -> None:
    PHASE_SECONDS.clear()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Wall-clock a pipeline phase, synchronising the card at its end."""
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    dt = time.perf_counter() - start
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt
    if not _QUIET:
        print(f"[gs2pc_torch] {name}: {dt:.2f}s", flush=True)
