"""Run a function on every rank of a pool of processes, one a device (the
counterpart of running a ``shard_map`` program over a mesh).

    result = launch.run(fn, devices, *args, root=..., timeout=...)
    launch.shutdown()

The calling process is rank 0.  Its first ``run`` on some devices starts
the pool: it spawns ranks 1 .. N-1 (``spawn``, since CUDA does not survive
``fork``) and joins them in a process group whose rendezvous is a
``FileStore`` in a temporary directory (no TCP port to pick).  Every later
``run`` on the same devices, with the same timeout, hands its job to the
same ranks over a pipe each, so a caller that converts scenes one after
another starts the ranks once.  In each job rank 0 calls
``fn(axis, *args, root=root)`` itself while rank r calls
``fn(axis, *args, root=None)``, ``axis`` its gs2pc_torch.parallel.group.
Axis on ``devices[r]``.  ``fn`` must be a module-level function (the ranks
import it); ``args`` are pickled to them; ``root`` stays in the caller,
unpickled (what rank 0 alone holds, a parsed scene).  ``run`` returns rank
0's result, so a conversion goes on in the caller.

The pool closes (its ranks told to exit, killed after a grace period, the
process group aborted on NCCL and destroyed on gloo) on ``shutdown()``, at
the caller's exit, on a ``run`` with other devices or another timeout
(which then starts a new pool), and after any failure.  A rank whose
caller dies exits.  RANK_STARTS counts the ranks started since import.

Rank r makes ``devices[r]`` current before any CUDA call; the caller's
current card is restored when ``run`` returns.  The kernel library is
built in the caller before any rank starts, so the ranks only load it.
The other ranks log nothing but the traceback of an error they raise;
after each job each sends the phase seconds of that job (gs2pc_torch.
utils.log.PHASE_SECONDS) to rank 0, which files them as
``rank<r>/<phase>``, with the bring-up in the pool's first job alone:

  spmd_spawn_import  spawn until the rank's code runs (interpreter, torch)
  spmd_cuda_context  the rank's CUDA context on its card
  spmd_library_load  loading the kernel library
  spmd_group_init    joining the process group (rank 0: from the first
                     spawn until every rank has joined)

Rank 0 adds what the pool costs a job as two spans: ``spmd_dispatch``
(handing the job to the ranks) and ``spmd_report`` (the wait, after ``fn``
returns on rank 0, for every rank's report).  Each spawned rank also
reports its launches of the conversion's kernels in the job (K1, K2, K5,
K6 and the record decode, kernel_launches), which rank 0 adds to RANK_LAUNCHES: the
wrappers' own counts in this process are rank 0's alone.

A rank that raises fails the run: rank 0 stops every other rank at once
(the process group's peers see their connections close, and on NCCL rank
0 aborts its own communicators), and ``run`` raises the first error that
any rank raised, with the rank's traceback as its cause; no rank is left
running, no group is left formed and nothing is retried.  ``timeout``
bounds every collective and the group's formation.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import datetime
import multiprocessing
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
# How long rank 0 waits, after an error or the end message, for the other
# ranks' reports or exits.
_GRACE_S = 10.0
# {rank: Counter of kernel_launches()} of the spawned ranks, summed over
# every successful run since it was last cleared.
RANK_LAUNCHES: dict = {}
# Rank processes started since import.
RANK_STARTS = 0
# The caller's pool of ranks, or None.
_POOL: Optional["_Pool"] = None


def kernel_launches() -> dict:
    """This process's launches of the conversion's kernels, by wrapper
    (each wrapper counts its own launches; see gs2pc_torch.ops)."""
    from gs2pc_torch.ops import blend_kernel, plydecode, projection, rasterize, sampler

    return {"blend_tiles": blend_kernel.blend_tiles.launches,
            "duplicate_with_keys": rasterize.duplicate_with_keys.launches,
            "order_pairs": rasterize.order_pairs.launches,
            "sample_points": sampler.sample_points.launches,
            "project_and_pack": projection.project_and_pack.launches,
            "preprocess": projection.preprocess.launches,
            "ply_decode": plydecode.ply_decode.launches}


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


def _exit_with_parent() -> None:
    """Exit this process as soon as the process that spawned it dies, even
    inside a job (a collective with a dead peer would wait for the
    timeout)."""
    parent = multiprocessing.parent_process()
    if parent is not None:
        threading.Thread(target=lambda: (wait([parent.sentinel]), os._exit(1)),
                         daemon=True).start()


def _rank_main(rank, devices, store_path, timeout, threads, spawned_at, jobs, reports):
    """A spawned rank: set up, then run each job ``(fn, args)`` rank 0 sends
    and report its phases and launches, until the end message (None) or
    the end of the pipe; an error is reported and ends the rank.

    It exits without destroying its process group: NCCL's destroy waits
    for every rank to destroy theirs, and rank 0 aborts its own group when
    it closes the pool.  The card is synchronised before each report, so
    that this rank's last collectives have completed."""
    log.PHASE_SECONDS["spmd_spawn_import"] = time.time() - spawned_at
    log.set_quiet(True)
    _exit_with_parent()
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(threads)
    code = 0
    try:
        axis = _setup(rank, devices, store_path, timeout)
        bringup = dict(log.PHASE_SECONDS)
        while (job := _next_job(jobs)) is not None:
            fn, args = job
            log.reset_phases()
            log.PHASE_SECONDS.update(bringup)
            bringup = {}
            before = kernel_launches()
            fn(axis, *args, root=None)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launched = {k: v - before[k] for k, v in kernel_launches().items()}
            reports.send(("ok", rank, dict(log.PHASE_SECONDS), launched))
    except BaseException as exc:  # report anything, then exit non-zero
        traceback.print_exc()
        with contextlib.suppress(OSError):
            reports.send(("error", time.time(), rank, _portable(exc), traceback.format_exc()))
        code = 1
    reports.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _next_job(jobs):
    """The next job from rank 0, or None at the end message or when rank 0
    has gone."""
    try:
        return jobs.recv()
    except EOFError:
        return None


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it survives pickling, else a RankFailed with its text."""
    try:
        return pickle.loads(pickle.dumps(exc))
    except Exception:
        return RankFailed(f"{type(exc).__name__}: {exc}")


class _Pool:
    """Rank 0's view of the spawned ranks and the group they formed.  A
    thread reads each job's reports and at the first error (or an exit
    without a report) stops every rank; the pool is then closed."""

    def __init__(self, devices: list, timeout: float):
        self.devices = devices
        self.timeout = timeout
        self.backend = backend_for(devices)
        self.tmp = tempfile.mkdtemp(prefix="gs2pc_torch_ranks_")
        self.store = os.path.join(self.tmp, "store")
        self.axis: Optional[Axis] = None
        self.procs: list = []
        self.jobs: list = []
        self.reports: list = []
        self._clear()

    def _clear(self) -> None:
        """Forget the last job's reports and errors."""
        self.errors: list = []  # (time, rank, exception, traceback text or None)
        self.phases: dict = {}
        self.launches: dict = {}
        self.failed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, threads: int) -> None:
        """Spawn ranks 1 .. N-1; they set up and wait for their first job."""
        global RANK_STARTS
        ctx = mp.get_context("spawn")
        for rank in range(1, len(self.devices)):
            job_recv, job_send = ctx.Pipe(duplex=False)
            report_recv, report_send = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main, name=f"gs2pc_torch rank {rank}", daemon=True,
                args=(rank, self.devices, self.store, self.timeout, threads, time.time(),
                      job_recv, report_send),
            )
            proc.start()
            job_recv.close()
            report_send.close()
            self.procs.append(proc)
            self.jobs.append(job_send)
            self.reports.append(report_recv)
        RANK_STARTS += len(self.procs)

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def watch(self) -> None:
        """Start a job: read its reports (and a rank's bring-up error) on a
        thread."""
        self._clear()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def dispatch(self, fn: Callable, args: tuple) -> None:
        for conn in self.jobs:
            conn.send((fn, args))

    def _watch(self) -> None:
        pending = {c: r for r, c in enumerate(self.reports, start=1)}
        alive = {p.sentinel: r for r, p in enumerate(self.procs, start=1)}
        while pending:
            for ready in wait(list(pending) + list(alive)):
                if ready in pending:
                    rank = pending.pop(ready)
                    try:
                        msg = ready.recv()
                    except EOFError:
                        self._exited(rank)
                        continue
                    if msg[0] == "ok":
                        self.phases[rank], self.launches[rank] = msg[2], msg[3]
                    else:
                        self.fail(*msg[1:])
                elif ready in alive:
                    rank = alive.pop(ready)
                    conn = self.reports[rank - 1]
                    if conn in pending and not conn.poll():
                        pending.pop(conn)
                        self._exited(rank)

    def _exited(self, rank: int) -> None:
        """Rank ``rank`` exited before its report of the job."""
        if not self.failed.is_set():
            self.procs[rank - 1].join(_GRACE_S)
            self.fail(time.time(), rank, RankFailed(
                f"rank {rank} exited with code {self.procs[rank - 1].exitcode}"), None)

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
        """Every spawned rank's report of the job, within ``timeout``."""
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

    def file_reports(self) -> None:
        """The job's phases as rank<r>/<phase>, its launches in RANK_LAUNCHES."""
        for rank, phases in sorted(self.phases.items()):
            for name, seconds in phases.items():
                log.PHASE_SECONDS[f"rank{rank}/{name}"] = seconds
        for rank, counts in self.launches.items():
            RANK_LAUNCHES.setdefault(rank, collections.Counter()).update(counts)

    def close(self) -> None:
        """Tell every rank to exit, kill what is left after the grace
        period, and take the process group down."""
        for conn in self.jobs:
            with contextlib.suppress(OSError):
                conn.send(None)
        deadline = time.monotonic() + _GRACE_S
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(_GRACE_S)
        if self._thread is not None:
            self._thread.join(_GRACE_S)
        for conn in self.jobs + self.reports:
            conn.close()
        if dist.is_initialized():
            if self.backend == "nccl":
                # The other ranks left without destroying theirs (_rank_main),
                # which NCCL's destroy would wait for.
                dist.distributed_c10d._abort_process_group()
            else:
                dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)


def shutdown() -> None:
    """Close this process's pool of ranks, if it has one (also run at exit)."""
    global _POOL
    pool, _POOL = _POOL, None
    if pool is not None:
        pool.close()


atexit.register(shutdown)


def run(fn: Callable, devices: Sequence[torch.device], *args, root: Any = None,
        timeout: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn`` on len(devices) ranks (module docstring); returns rank 0's
    result.  Needs a process without a process group of its own making."""
    global _POOL
    devices = [torch.device(d) for d in devices]
    backend_for(devices)  # raises on a mix no backend takes
    pool = _POOL
    if pool is not None and (pool.devices != devices or pool.timeout != timeout
                             or not pool.alive()):
        shutdown()
        pool = None
    if pool is None and dist.is_initialized():
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
    fresh = pool is None
    if fresh:
        pool = _POOL = _Pool(devices, timeout)
    done = False
    result = None
    try:
        try:
            if fresh:
                with log.phase("spmd_group_init"):
                    pool.start(torch.get_num_threads())
                    pool.watch()
                    pool.axis = _setup(0, devices, pool.store, timeout)
            else:
                pool.watch()
                if devices[0].type == "cuda":
                    torch.cuda.set_device(devices[0])
            with log.span("spmd_dispatch"):
                pool.dispatch(fn, args)
            result = fn(pool.axis, *args, root=root)
        except BaseException as exc:  # stop the other ranks, then raise the first error
            pool.fail(time.time(), 0, exc, None)
        with log.span("spmd_report"):
            pool.wait(timeout)
        pool.raise_first()
        pool.file_reports()
        done = True
        return result
    finally:
        if not done:
            shutdown()
        torch.set_num_threads(threads)
        if current is not None:
            torch.cuda.set_device(current)


def in_turn(axis, calls: Sequence[tuple], root: Optional[Sequence] = None) -> list:
    """A rank function that runs several in one job: ``calls[i]`` = (rank
    function, its args), with ``root[i]`` its root on rank 0.  Returns the
    list of their results."""
    return [fn(axis, *args, root=None if root is None else root[i])
            for i, (fn, args) in enumerate(calls)]
