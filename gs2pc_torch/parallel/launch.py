"""Start one process per rank and run a function on every rank (the
counterpart of running a ``shard_map`` program over a mesh).

    result = launch.run(fn, devices, *args, root=..., timeout=...)

The calling process is rank 0: it spawns ranks 1 .. N-1 (``spawn``, since
CUDA does not survive ``fork``), joins them in a process group whose
rendezvous is a ``FileStore`` in a temporary directory (no TCP port to
pick), and calls ``fn(axis, *args, root=root)`` itself, while rank r calls
``fn(axis, *args, root=None)`` with ``axis`` its gs2pc_torch.parallel.
group.Axis on ``devices[r]``.  ``fn`` must be a module-level function (the
children import it); ``args`` are pickled to them; ``root`` stays in the
caller, unpickled (what rank 0 alone holds, a parsed scene).  ``run``
returns rank 0's result, so a conversion goes on in the caller.

Rank r makes ``devices[r]`` current before any CUDA call; the caller's
current card is restored when ``run`` returns.  The kernel
library is built in the caller before any rank starts, so the ranks only
load it.  The other ranks log nothing; each sends its phase seconds
(gs2pc_torch.utils.log.PHASE_SECONDS) to rank 0, which files them as
``rank<r>/<phase>``, the bring-up apart:

  spmd_spawn_import  spawn until the rank's code runs (interpreter, torch)
  spmd_cuda_context  the rank's CUDA context on its card
  spmd_library_load  loading the kernel library
  spmd_group_init    joining the process group (rank 0: from the first
                     spawn until every rank has joined)

Each spawned rank also reports its launches of the conversion's kernels
(K1, K2, K5 and K6, kernel_launches), which rank 0 adds to RANK_LAUNCHES: the
wrappers' own counts in this process are rank 0's alone.

A rank that raises fails the run: rank 0 stops every other rank at once
(the process group's peers see their connections close, and on NCCL rank
0 aborts its own communicators), and ``run`` raises the first error that
any rank raised, with the rank's traceback as its cause; no rank is left
running and nothing is retried.  ``timeout`` bounds every collective and
the group's formation.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gs2pc_torch.parallel.group import Axis, backend_for
from gs2pc_torch.utils import log

DEFAULT_TIMEOUT_S = 300.0
# How long rank 0 waits, after an error, for the other ranks' reports.
_GRACE_S = 10.0
# {rank: Counter of kernel_launches()} of the spawned ranks, summed over
# every successful run since it was last cleared.
RANK_LAUNCHES: dict = {}


def kernel_launches() -> dict:
    """This process's launches of the conversion's kernels, by wrapper
    (each wrapper counts its own launches; see gs2pc_torch.ops)."""
    from gs2pc_torch.ops import blend_kernel, projection, rasterize, sampler

    return {"blend_tiles": blend_kernel.blend_tiles.launches,
            "duplicate_with_keys": rasterize.duplicate_with_keys.launches,
            "order_pairs": rasterize.order_pairs.launches,
            "sample_points": sampler.sample_points.launches,
            "project_and_pack": projection.project_and_pack.launches,
            "preprocess": projection.preprocess.launches}


class RemoteTraceback(Exception):
    """The traceback of an error raised on another rank."""

    def __init__(self, rank: int, text: str):
        super().__init__(f"on rank {rank}:\n{text}")


class RankFailed(RuntimeError):
    """A rank exited or raised an error that could not cross to rank 0."""


def _setup(rank: int, devices, store_path: str, timeout: float) -> Axis:
    """Make ``devices[rank]`` current, bring up its CUDA context and the
    kernel library (rank 0, the caller, has both), join the group; each
    step of a spawned rank timed as a phase."""
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if rank > 0:
            with log.phase("spmd_cuda_context"):
                torch.zeros(1, device=device)
            from gs2pc_torch.ops import cuda_build

            with log.phase("spmd_library_load"):
                cuda_build.load_library()
    backend = backend_for(devices)
    with log.phase("spmd_group_init") if rank > 0 else contextlib.nullcontext():
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, len(devices)), rank=rank,
            world_size=len(devices), timeout=datetime.timedelta(seconds=timeout),
            device_id=device if backend == "nccl" else None,
        )
    return Axis(rank, len(devices), device)


def _rank_main(rank, devices, fn, args, store_path, timeout, threads, spawned_at, conn):
    """A spawned rank: set up, run ``fn``, report to rank 0 and exit.

    It exits without destroying its process group: NCCL's destroy waits
    for every rank to destroy theirs, and rank 0 goes on alone after the
    collective part (a conversion's sampler and writer); rank 0 aborts its
    own group at the end of ``run``.  The card is synchronised first, so
    that this rank's last collectives have completed before it leaves."""
    log.PHASE_SECONDS["spmd_spawn_import"] = time.time() - spawned_at
    log.set_quiet(True)
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(threads)
    try:
        fn(_setup(rank, devices, store_path, timeout), *args, root=None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        conn.send(("ok", rank, dict(log.PHASE_SECONDS), kernel_launches()))
        code = 0
    except BaseException as exc:  # report anything, then exit non-zero
        conn.send(("error", time.time(), rank, _portable(exc), traceback.format_exc()))
        code = 1
    conn.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it survives pickling, else a RankFailed with its text."""
    try:
        return pickle.loads(pickle.dumps(exc))
    except Exception:
        return RankFailed(f"{type(exc).__name__}: {exc}")


class _Ranks:
    """Rank 0's view of the spawned ranks: a thread reads their reports and
    at the first error (or an exit without one) stops them all."""

    def __init__(self, backend: str):
        self.backend = backend
        self.procs: list = []
        self.conns: list = []
        self.errors: list = []  # (time, rank, exception, traceback text or None)
        self.phases: dict = {}
        self.launches: dict = {}
        self.failed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, fn, devices, args, store: str, timeout: float, threads: int) -> None:
        ctx = mp.get_context("spawn")
        for rank in range(1, len(devices)):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main, name=f"gs2pc_torch rank {rank}",
                args=(rank, devices, fn, args, store, timeout, threads, time.time(), send),
            )
            proc.start()
            send.close()
            self.procs.append(proc)
            self.conns.append(recv)
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        pending = {c: r for r, c in enumerate(self.conns, start=1)}
        alive = {p.sentinel: r for r, p in enumerate(self.procs, start=1)}
        reported = set()
        while pending or alive:
            for ready in wait(list(pending) + list(alive)):
                if ready in pending:
                    rank = pending.pop(ready)
                    try:
                        msg = ready.recv()
                    except EOFError:
                        continue
                    reported.add(rank)
                    if msg[0] == "ok":
                        self.phases[rank], self.launches[rank] = msg[2], msg[3]
                    else:
                        self.fail(*msg[1:])
                elif ready in alive:
                    rank = alive.pop(ready)
                    conn = self.conns[rank - 1]
                    if conn in pending and conn.poll():
                        continue  # its report is still to be read
                    code = self.procs[rank - 1].exitcode
                    if code != 0 and rank not in reported:
                        self.fail(time.time(), rank,
                                  RankFailed(f"rank {rank} exited with code {code}"), None)

    def fail(self, when: float, rank: int, exc: BaseException, text: Optional[str]) -> None:
        """Record an error; at the first, stop every spawned rank."""
        self.errors.append((when, rank, exc, text))
        if self.failed.is_set():
            return
        self.failed.set()
        for p in self.procs:
            if p.is_alive():
                p.kill()
        if self.backend == "nccl" and dist.is_initialized():
            # Rank 0 may wait in a collective on a peer that is gone, which
            # NCCL would do until the timeout.
            dist.distributed_c10d._abort_process_group()

    def wait(self, timeout: float) -> None:
        """Every spawned rank's report or exit, within ``timeout``."""
        if self._thread is None:
            return
        self._thread.join(_GRACE_S if self.failed.is_set() else timeout)
        if self._thread.is_alive() and not self.failed.is_set():
            self.fail(time.time(), 0, RankFailed(
                f"ranks still running {timeout:g} s after rank 0 finished"), None)

    def raise_first(self) -> None:
        """Raise the earliest error of any rank (the others follow from it)."""
        if not self.errors:
            return
        _, rank, exc, text = min(self.errors, key=lambda e: e[0])
        if not text:
            raise exc
        raise exc from RemoteTraceback(rank, text)

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(_GRACE_S)
        if self._thread is not None:
            self._thread.join(_GRACE_S)


def run(fn: Callable, devices: Sequence[torch.device], *args, root: Any = None,
        timeout: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn`` on len(devices) ranks (module docstring); returns rank 0's
    result.  Needs a process without a default process group."""
    devices = [torch.device(d) for d in devices]
    backend = backend_for(devices)
    if dist.is_initialized():
        raise RuntimeError("launch.run forms its own process group; this process has one")
    if devices[0].type == "cuda":
        from gs2pc_torch.ops import cuda_build

        cuda_build.load_library()  # built here once; the ranks only load it
    # CPU ranks share the caller's intra-op threads: N processes with a
    # thread per core each would oversubscribe the cores N times.
    threads = torch.get_num_threads()
    if devices[0].type == "cpu":
        torch.set_num_threads(max(1, threads // len(devices)))
    current = torch.cuda.current_device() if devices[0].type == "cuda" else None
    tmp = tempfile.mkdtemp(prefix="gs2pc_torch_ranks_")
    ranks = _Ranks(backend)
    result = None
    try:
        try:
            with log.phase("spmd_group_init"):
                ranks.start(fn, devices, args, os.path.join(tmp, "store"), timeout,
                            torch.get_num_threads())
                axis = _setup(0, devices, os.path.join(tmp, "store"), timeout)
            result = fn(axis, *args, root=root)
        except BaseException as exc:  # stop the other ranks, then raise the first error
            ranks.fail(time.time(), 0, exc, None)
        ranks.wait(timeout)
        ranks.raise_first()
        for rank, phases in sorted(ranks.phases.items()):
            for name, seconds in phases.items():
                log.PHASE_SECONDS[f"rank{rank}/{name}"] = seconds
        for rank, counts in ranks.launches.items():
            RANK_LAUNCHES.setdefault(rank, collections.Counter()).update(counts)
        return result
    finally:
        ranks.stop()
        if dist.is_initialized():
            if backend == "nccl":
                # The other ranks left without destroying theirs (_rank_main),
                # which NCCL's destroy would wait for.
                dist.distributed_c10d._abort_process_group()
            else:
                dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.set_num_threads(threads)
        if current is not None:
            torch.cuda.set_device(current)


def in_turn(axis, calls: Sequence[tuple], root: Optional[Sequence] = None) -> list:
    """A rank function that runs several in one process group: ``calls[i]``
    = (rank function, its args), with ``root[i]`` its root on rank 0.
    Returns the list of their results."""
    return [fn(axis, *args, root=None if root is None else root[i])
            for i, (fn, args) in enumerate(calls)]
