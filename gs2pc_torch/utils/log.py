"""Quiet-gated logging + phase timing (the PyTorch counterpart of
gs2pc.utils.log, with the same ``phase()``/``PHASE_SECONDS`` API).

Phases are annotated with ``torch.profiler.record_function`` so a profiler
trace shows them, and a phase that ran CUDA work ends with a device
synchronise: PyTorch returns before the card finishes, so without it the
wall-clock of a phase would measure the enqueue, not the work.

Two lighter helpers sit beside ``phase``, for steps inside a phase:
``span`` adds its host-clock seconds to ``PHASE_SECONDS`` (from any
thread) and never synchronises, so it can time host work that overlaps
the card's; ``trace_range`` only names a stretch in a profiler trace.  Both
open their ``record_function`` range only while a profiler records: a
range costs ~10 us a call even with none, the check ~0.1 us.  A range
opened on a thread other than the main one does not reach torch.profiler's
events, so a worker's span is host clock only.
"""

from __future__ import annotations

import contextlib
import threading
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


# Accumulated wall-clock per phase (and span) name since the last
# reset_phases(); spans add from worker threads too, under _LOCK.
PHASE_SECONDS: dict[str, float] = {}
_LOCK = threading.Lock()


def reset_phases() -> None:
    with _LOCK:
        PHASE_SECONDS.clear()


def _add_seconds(name: str, dt: float) -> None:
    with _LOCK:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Wall-clock a pipeline phase, synchronising the card at its end."""
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    dt = time.perf_counter() - start
    _add_seconds(name, dt)
    if not _QUIET:
        print(f"[gs2pc_torch] {name}: {dt:.2f}s", flush=True)


def trace_range(name: str):
    """A profiler range called ``name`` while a profiler records, else a
    no-op; adds nothing to PHASE_SECONDS."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Add the host-clock seconds of the block to PHASE_SECONDS[name], from
    any thread, without synchronising the card (a span times the host's
    work, such as a parse thread's or the enqueue of an upload; the phase
    around it waits for the card); a profiler range too while a profiler
    records (trace_range)."""
    start = time.perf_counter()
    with trace_range(name):
        yield
    _add_seconds(name, time.perf_counter() - start)
