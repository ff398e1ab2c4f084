"""Times K1 (every mode) and K2 at the main path's shape: camera 0 of the
capture scene (3M Gaussians, 1280x720, its vignette mask, surface pass,
compact tables, run cap 4096) and, for K1's depth-slab modes, slab 1 of 4
of the same camera, with the inputs the depth-slab sweep gives it; K5 on
that scene (the PSD clamp applied) at 10M points of quotas by size, key
PRNGKey(0); K6, the per-camera front end, on camera 0 of that scene (full
rect, compact table) beside its twin (a checkout without K6: the eager
preprocess + pack_blend_table it runs instead); and the probes at the
tools' shapes: K3 per op on the seeded uniform block of cuda_probe, K4 at
level 6 on the seeded input of cuda_probe2; and the scene load's record
decode (ops.plydecode) on one block of a degree-3 INRIA export
(CARD_BLOCK_ROWS records of 248 B) beside the block's pinned copy to the card,
its twin, and the host parse's fill of the same block, which it replaces.

Each kernel is timed two ways with CUDA events, the mean over ``--reps``
after a warm-up (ten times as many for the probes): through its wrapper
(allocations and the PyTorch work around the launch included), and the
launch alone (the C entry point, replayed on the arguments the wrapper
gives it; every entry point is idempotent on its outputs).  K2's scan +
sync is the wrapper's time less its count and write launches; ``order_ms``
times the whole ordering of the pairs through the wrapper.  Beside the
probes: their kernels' own device time (torch.profiler), the floor (an
empty kernel's entry point replayed the same way, before and after them),
and the PyTorch calls that compute K3's roll and scan (torch.roll,
torch.cumprod), which the port never calls.  ``--gaussians 0`` times the
probes alone; ``--kernels`` picks which of probes, k1, k2, k5, k6 and ply
run.

    python gs2pc_torch/tools/bench_kernels.py [--root DIR] [--e2e N [--profile]
        [--num_devices N] [--e2e_only]] [--gaussians 3000000] [--kernels k5]
        [--reps 20] [--out FILE]

``--root`` imports ``gs2pc_torch`` from another checkout (the tool runs as
a file, so the same script times an older tree beside this one: run them
in turns, A B B A, in one call on one card).  ``--e2e N`` also runs the
production conversion of that scene (16 cameras, 10M points) N times
through ``cli.main`` and records each wall and its phases; ``--profile``
adds one run under torch.profiler (the card's busy time, its top kernels,
and for scene_parse, scene_upload, point_sampling and ply_write the copies
by kind, the kernels' time and the host time outside PyTorch's ops);
``--num_devices`` passes the CLI's own flag (on a machine with several
cards, 1 runs one card and 0, the CLI's default, every card, one process
each); ``--e2e_only`` skips the kernels.  A card is required.  Prints one JSON
object as its last line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from typing import Optional, Sequence
from unittest import mock

N_SLABS = 4
K1_ENTRY = "gs2pc_blend_tiles"
K2_ENTRIES = ("gs2pc_count_pairs", "gs2pc_write_pairs")
K3_ENTRY = "gs2pc_probe_op"
K4_ENTRY = "gs2pc_probe_blend"
FLOOR_ENTRY = "gs2pc_probe_floor"
K5_ENTRY = "gs2pc_sample_points"
K6_ENTRY = "gs2pc_project_pack"
PLY_ENTRY = "gs2pc_ply_decode"
N_POINTS = 10_000_000
KERNELS = ("probes", "k1", "k2", "k5", "k6", "ply")
# H100 SXM's device memory bandwidth, bytes/s (the bound of the record decode).
HBM_BYTES_PER_S = 3.35e12
# K3's ops that one PyTorch call computes (x is the (256, 128) block).
K3_LIBRARY = {"roll": lambda x: x.roll(4, 1), "scan": lambda x: x.cumprod(1)}


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _TimedLibrary:
    """Stands in for the kernel library: each call of an entry point in
    ``names`` runs once, then ``reps`` more times between two CUDA events
    on the current stream; other entry points pass through."""

    def __init__(self, lib, names, reps: int):
        self._lib, self._names, self._reps = lib, set(names), reps
        self.ms = collections.defaultdict(list)

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._names:
            return fn

        def timed(*args):
            import torch

            rc = fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self._reps):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            self.ms[name].append(start.elapsed_time(end) / self._reps)
            return rc

        return timed


def launch_ms(call, names, reps: int) -> dict:
    """{entry point: mean device ms of one launch} for each C entry point in
    ``names`` that ``call()`` reaches through ``cuda_build.load_library``."""
    from gs2pc_torch.ops import cuda_build

    proxy = _TimedLibrary(cuda_build.load_library(), names, reps)
    with mock.patch.object(cuda_build, "load_library", lambda: proxy):
        call()
    return {n: sum(v) / len(v) for n, v in proxy.ms.items()}


def kernel_ptxas(log: str, kernel: str) -> str:
    """The ptxas stack / spill and register / shared-memory lines of the
    kernels whose name contains ``kernel``."""
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and kernel in ln:
            out += [x.strip() for x in lines[i + 1:i + 4] if "Compiling" not in x]
    return " | ".join(out)


def camera_inputs(n_gaussians: int, device):
    """K1's main-mode inputs on camera 0 and the slab-1 calls of the
    depth-slab sweep, built by the checkout's own stages."""
    from gs2pc_torch.camera import build_camera_batch
    from gs2pc_torch.models.gaussians import Gaussians
    from gs2pc_torch.ops import blend_kernel as B
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.ops.projection import preprocess
    from gs2pc_torch.parallel.gauss_shard import render_sweep_gauss_sharded
    from gs2pc_torch.sweep import render_arrays
    from gs2pc_torch.utils import capture

    a = capture.make_scene_arrays(n_gaussians)
    g = Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours, a.opacities, device=device)
    transforms, intr = capture.make_poses(1, 1280, 720)
    m = capture.vignette_mask(1280, 720)
    cams = build_camera_batch(transforms, intr, masks={n: m for n in transforms}, device=device)
    cam = cams.at(0)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad,
                       compact=True, surface_compact=True)
    prep = preprocess(g.xyz, g.covariance_factors(), g.opacities, g.keep_mask, cam,
                      adaptive_radius=False)
    args, kw, _ = R.blend_inputs(prep, g.colours, cam, cfg, calc_surface_distance=True)
    calls = []

    def record(*a_, **k_):
        calls.append((a_, k_))
        return B.blend_tiles(*a_, **k_)

    with mock.patch.object(R, "blend_tiles", record):
        render_sweep_gauss_sharded(render_arrays(g), cams, cfg, [device] * N_SLABS)
    modes = {"main": (args, kw)}
    for a_, k_ in calls[1::N_SLABS]:
        modes[B.mode_of(k_["init_trans"], k_["ed_override"], k_["early_stop"])] = (a_, k_)
    return prep, cfg, modes


def time_k1(modes, reps: int) -> dict:
    from gs2pc_torch.ops import blend_kernel as B

    out = {}
    for mode, (args, kw) in modes.items():
        launch = launch_ms(lambda: B.blend_tiles(*args, **kw), [K1_ENTRY], reps)
        wrapper = cuda_ms(lambda: B.blend_tiles(*args, **kw), reps)
        out[mode] = {"launch_ms": launch[K1_ENTRY], "wrapper_ms": wrapper,
                     "pairs": int(args[1].numel())}
    return out


def time_k2(prep, cfg, reps: int) -> dict:
    """K2's launches and wrapper, and ``order_ms``: the pairs from the
    preprocess to K1's order (the depth sort, K2 in rank order and the tile
    sort; in a checkout without the depth sort, K2 and the int64 key sort
    with its gid gather)."""
    from gs2pc_torch.ops import rasterize as R

    if hasattr(R, "order_pairs"):
        order = R.depth_order(prep.depth, prep.valid)

        def call():
            return R.duplicate_with_keys(prep, cfg, False, order)

        def ordered():
            return R.order_pairs(prep, cfg, False)
    else:
        def call():
            return R.duplicate_with_keys(prep, cfg, circle_cull=False)

        def ordered():
            return R.sort_pairs(*call())

    launch = launch_ms(call, K2_ENTRIES, reps)
    wrapper = cuda_ms(call, reps)
    count, write = (launch[n] for n in K2_ENTRIES)
    return {"count_ms": count, "write_ms": write, "scan_sync_ms": wrapper - count - write,
            "wrapper_ms": wrapper, "order_ms": cuda_ms(ordered, reps),
            "pairs": int(call()[0].numel())}


def time_k5(n_gaussians: int, device, reps: int) -> dict:
    """K5 at the e2e cell's width: the capture scene with the PSD clamp
    applied, N_POINTS points of quotas by size, key PRNGKey(0)."""
    from gs2pc_torch.models.gaussians import Gaussians
    from gs2pc_torch.ops import prng
    from gs2pc_torch.ops import sampler as S
    from gs2pc_torch.utils import capture

    a = capture.make_scene_arrays(n_gaussians)
    g = Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours, a.opacities,
                             device=device).validate_covariances()
    ppg = S.distribute_points(g.magnitudes(), N_POINTS)
    n_cap = N_POINTS + max(4096, N_POINTS // 20)

    def call():
        return S.sample_points(prng.PRNGKey(0), g, ppg, n_cap)

    return {"launch_ms": launch_ms(call, [K5_ENTRY], reps)[K5_ENTRY],
            "wrapper_ms": cuda_ms(call, reps), "points": int(call().points.shape[0])}


def time_k6(n_gaussians: int, device, reps: int) -> dict:
    """The per-camera front end on camera 0 of the capture scene (its mask,
    full rect for the surface pass, compact table), as the checkout runs it
    in render_tile_camera: K6 (projection.project_and_pack) launch alone and
    through the wrapper, and its twin (preprocess_torch + pack_blend_table);
    in a checkout without K6, the eager preprocess + pack_blend_table it
    runs instead, as ``wrapper_ms``."""
    from gs2pc_torch.camera import build_camera_batch
    from gs2pc_torch.models.gaussians import Gaussians
    from gs2pc_torch.ops import projection as PJ
    from gs2pc_torch.ops import rasterize as R
    from gs2pc_torch.utils import capture

    a = capture.make_scene_arrays(n_gaussians)
    g = Gaussians.from_numpy(a.xyz, a.log_scales, a.rots, a.colours, a.opacities, device=device)
    transforms, intr = capture.make_poses(1, 1280, 720)
    m = capture.vignette_mask(1280, 720)
    cams = build_camera_batch(transforms, intr, masks={n: m for n in transforms}, device=device)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad, compact=True)
    gauss = (g.xyz, g.covariance_factors(), g.opacities, g.keep_mask)
    cam = cams.at(0)

    def eager():
        prep = PJ.preprocess(*gauss, cam, adaptive_radius=False)
        return R.pack_blend_table(prep, g.colours, compact=True)

    if not hasattr(PJ, "project_and_pack"):
        return {"wrapper_ms": cuda_ms(eager, reps), "route": "eager"}

    def call():
        return PJ.project_and_pack(*gauss, g.colours, cam, cfg, False)

    def twin():
        prep = PJ.preprocess_torch(*gauss, cam, False)
        return R.pack_blend_table(prep, g.colours, compact=True)

    return {"launch_ms": launch_ms(call, [K6_ENTRY], reps)[K6_ENTRY],
            "wrapper_ms": cuda_ms(call, reps), "plain_ms": cuda_ms(twin, max(reps // 4, 1)),
            "route": "k6"}


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds of ``fn`` over ``reps`` calls after a warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def time_ply_decode(device, reps: int) -> dict:
    """The record decode on one block of a degree-3 INRIA export (normals
    and all, 248 B a record; seeded normal values), compact colours and no
    SH plane, as the card load runs it: launch alone and through the
    wrapper; the block's pinned copy to the card; the twin on the host; and
    the host parse's fill of the same block (gaussians_io._Planes.fill),
    which it replaces.  The bound: 248 B read and 52 B (xyz, colours,
    log_scales, rots) written a row at the card's bandwidth."""
    import numpy as np
    import torch

    from gs2pc_torch.io import gaussians_io as G
    from gs2pc_torch.io.ply import PlyElement
    from gs2pc_torch.ops import plydecode

    names = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(45)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    rows = G.CARD_BLOCK_ROWS
    recs = np.zeros(rows, [(p, "<f4") for p in names])
    rng = np.random.default_rng(0)
    for p in names:
        recs[p] = rng.normal(size=rows)
    vertex = PlyElement("vertex", rows)
    vertex.properties = [(p, "f4") for p in names]
    layout = G._card_layout("binary_little_endian", vertex, 3)
    host = torch.from_numpy(recs.view(np.uint8).copy()).pin_memory()
    records = host.to(device)
    shapes = {"xyz": (rows, 3), "colours": (rows, 3), "log_scales": (rows, 3), "rots": (rows, 4)}
    planes = {k: torch.empty(s, dtype=torch.float32, device=device) for k, s in shapes.items()}
    cpu_planes = {k: torch.empty(s, dtype=torch.float32) for k, s in shapes.items()}

    def call():
        plydecode.ply_decode(records, rows, 0, layout, planes, True)

    def fill():
        G._Planes(names, rows, 3, False, lambda n, s: np.empty(s, np.float32), True).fill(
            recs, 0, span=G._untimed)

    return {"rows": rows, "stride": layout.stride,
            "launch_ms": launch_ms(call, [PLY_ENTRY], reps)[PLY_ENTRY],
            "wrapper_ms": cuda_ms(call, reps),
            "copy_ms": cuda_ms(lambda: records.copy_(host, non_blocking=True), reps),
            "plain_ms": host_ms(lambda: plydecode.ply_decode_torch(
                host, rows, 0, layout, cpu_planes, True), max(reps // 4, 1)),
            "host_fill_ms": host_ms(fill, reps),
            "bound_ms": rows * (layout.stride + 52) / HBM_BYTES_PER_S * 1e3}


def _device_us(e) -> float:
    """A profiler event's own time on the card, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernel_device_ms(fn, kernel: str, n: int) -> float:
    """Device ms a call of ``fn`` spends in kernels whose name contains
    ``kernel``, the mean over ``n`` calls under torch.profiler: the
    kernels' own time, without the host's launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages() if kernel in e.key) / 1e3 / n


def floor_call(device):
    """One launch of the empty kernel through its C entry point, or None for
    a library without it."""
    import torch

    from gs2pc_torch.ops import cuda_build

    if getattr(cuda_build.load_library(), FLOOR_ENTRY, None) is None:
        return None
    stream = torch.cuda.current_stream(device).cuda_stream
    return lambda: getattr(cuda_build.load_library(), FLOOR_ENTRY)(stream)


def time_probes(device, reps: int) -> dict:
    """K3 per op and K4 at level 6: launch alone, through the wrapper, and
    the kernels' own device time (torch.profiler); the floor, the empty
    kernel launched alone before and after them (``floor_ms`` their mean)
    and its device time; the library calls of K3's roll and scan.  A few
    hundred ms of matrix products first bring the card's clocks up, which
    launches of a few microseconds alone would not."""
    import torch

    from gs2pc_torch.ops import probe_kernels as PK
    from gs2pc_torch.tools import cuda_probe, cuda_probe2

    a = torch.ones((4096, 4096), device=device)
    for _ in range(100):
        a @ a
    torch.cuda.synchronize(device)
    floor = floor_call(device)
    rec = {"floor_range_ms": [launch_ms(floor, [FLOOR_ENTRY], reps)[FLOOR_ENTRY]] if floor
           else []}
    x = cuda_probe.make_input("uniform", device, seed=0)
    k3 = {}
    for _, op in PK.PROBE_OPS:
        def call(op=op):
            return PK.probe_op(op, x)

        k3[op] = {"launch_ms": launch_ms(call, [K3_ENTRY], reps)[K3_ENTRY],
                  "wrapper_ms": cuda_ms(call, reps),
                  "device_ms": kernel_device_ms(call, "probe_", 50)}
    inputs = cuda_probe2.make_inputs("seeded", device, seed=0)

    def k4():
        return PK.probe_blend(6, *inputs)

    rec["k3"] = k3
    rec["k4"] = {"launch_ms": launch_ms(k4, [K4_ENTRY], reps)[K4_ENTRY],
                 "wrapper_ms": cuda_ms(k4, reps),
                 "device_ms": kernel_device_ms(k4, "probe_blend", 50)}
    rec["library_ms"] = {op: cuda_ms(lambda f=f: f(x), reps) for op, f in K3_LIBRARY.items()}
    rec["floor_ms"] = rec["floor_device_ms"] = None
    if floor:
        rec["floor_range_ms"].append(launch_ms(floor, [FLOOR_ENTRY], reps)[FLOOR_ENTRY])
        rec["floor_ms"] = sum(rec["floor_range_ms"]) / 2
        rec["floor_device_ms"] = kernel_device_ms(floor, "probe_floor", 50)
    return rec


# The phases whose host transfers device_profile breaks down.
TRANSFER_PHASES = ("scene_parse", "scene_upload", "point_sampling", "ply_write")


def _trace(path: str) -> tuple:
    """(events, phase ranges (start, end, name, pid, tid), host call time by
    correlation id) of a torch.profiler Chrome trace; the phases are the
    ranges utils.log.phase records."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    phases = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("pid"), e.get("tid"))
              for e in events if e.get("cat") == "user_annotation"]
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    return events, phases, issued


def _phase_of(ts, phases, names) -> Optional[str]:
    around = [p for p in phases if p[2] in names and ts is not None and p[0] <= ts <= p[1]]
    return min(around, key=lambda p: p[1] - p[0])[2] if around else None


def trace_copies(path: str, names: Sequence[str]) -> list:
    """The device copies of a torch.profiler Chrome trace: (kind, e.g.
    "Memcpy DtoH (Device -> Pageable)", bytes, device ms, the innermost of
    the phases ``names`` around the host call that issued it, or None)."""
    events, phases, issued = _trace(path)
    copies = []
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        args = e.get("args", {})
        if "bytes" not in args:
            raise ValueError(f"the profiler's copy {e.get('name')} carries no byte count")
        phase = _phase_of(issued.get(args.get("correlation")), phases, names)
        copies.append((e["name"], int(args["bytes"]), e.get("dur", 0) / 1e3, phase))
    return copies


def trace_phases(path: str, names: Sequence[str] = TRANSFER_PHASES) -> dict:
    """Each phase ``names`` of a torch.profiler Chrome trace: its wall (ms),
    the device copies its host calls issued by kind (count, bytes, device
    ms), the device ms of its kernels, and its host ms outside every
    PyTorch op and CUDA call (numpy and Python work, the native writer)."""
    events, phases, issued = _trace(path)
    out = {}
    for start, end, name, pid, tid in phases:
        if name not in names:
            continue
        rec = out.setdefault(name, {"wall_ms": 0.0, "copies": {}, "kernels_ms": 0.0,
                                    "host_outside_ops_ms": 0.0})
        rec["wall_ms"] += (end - start) / 1e3
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                       if e.get("cat") in ("cpu_op", "cuda_runtime") and e.get("pid") == pid
                       and e.get("tid") == tid and start <= e["ts"] <= end)
        covered, reach = 0.0, start
        for a, b in spans:
            a, b = max(a, reach), min(b, end)
            if b > a:
                covered += b - a
                reach = b
        rec["host_outside_ops_ms"] += (end - start - covered) / 1e3
    for e in events:
        cat = e.get("cat")
        if cat not in ("gpu_memcpy", "kernel"):
            continue
        phase = _phase_of(issued.get(e.get("args", {}).get("correlation")), phases, names)
        if phase is None:
            continue
        if cat == "kernel":
            out[phase]["kernels_ms"] += e.get("dur", 0) / 1e3
            continue
        k = out[phase]["copies"].setdefault(e["name"], {"count": 0, "bytes": 0, "ms": 0.0})
        k["count"] += 1
        k["bytes"] += int(e["args"].get("bytes", 0))
        k["ms"] += e.get("dur", 0) / 1e3
    return out


def device_profile(fn, trace: str) -> dict:
    """Run ``fn`` once under torch.profiler: its wall, the card's busy time
    (device_busy_s: the union of every kernel's and copy's interval on the
    card), the kernels that took the most of it, and trace_phases of the
    transfer phases (the Chrome trace written to ``trace`` on the way, then
    removed)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    phases = trace_phases(trace)
    busy = device_busy_s(trace)
    os.remove(trace)

    # Device-side events, without the phase ranges (user annotations).
    from gs2pc_torch.utils import log

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.key not in log.PHASE_SECONDS]
    events = sorted(kernels, key=_device_us, reverse=True)
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "top_ms": {e.key[:60]: _device_us(e) / 1e3 for e in events[:10]},
            "phases": phases}


# What runs on the card in a torch.profiler Chrome trace (its annotations,
# "gpu_user_annotation", left out).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_s(path: str) -> float:
    """Seconds of a torch.profiler Chrome trace in which at least one
    kernel, copy or memset ran on the card: the union of their intervals,
    whatever stream each ran on.  A sum would count twice the time the
    side streams (the scene's upload, the points' fetch) overlap the
    sweep.  The union is the benchmark's (benchmarks/gsbench/trace.py,
    union_seconds), copied: the program imports nothing of the benchmark."""
    events, _, _ = _trace(path)
    busy, reach = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                       if e.get("cat") in DEVICE_CATEGORIES):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy / 1e6


def time_e2e(root: str, n_gaussians: int, n_runs: int, profile: bool,
             extra: Sequence[str] = ()) -> dict:
    """The production conversion on the capture scene (16 cameras at
    1280x720 with masks, 10M points, surface distances on) through
    ``cli.main`` with the arguments ``extra`` added, ``n_runs`` times: per
    run the wall, disk to disk, and the phases of
    ``utils.log.PHASE_SECONDS`` (with a sweep over several cards, the
    spawned ranks' too, as ``rank<r>/<phase>``); with ``profile``, one more
    run under ``device_profile``."""
    import shutil

    from gs2pc_torch import cli
    from gs2pc_torch.utils import capture, log

    work = os.path.join(root, "build", "bench_kernels_e2e")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        a = capture.make_scene_arrays(n_gaussians)
        transforms, intr = capture.make_poses(16, 1280, 720)
        ply, tj, mask_dir = capture.write_capture(work, a, transforms, intr, with_masks=True)
        argv = ["--input_path", ply, "--transform_path", tj, "--mask_path", mask_dir,
                "--output_path", os.path.join(work, "cloud.ply"), "--num_points", "10000000",
                "--surface_distance_std", "1e6", "--seed", "0", "--quiet", *extra]
        runs = []
        for _ in range(n_runs):
            log.reset_phases()
            t0 = time.perf_counter()
            cli.main(argv)
            runs.append(dict(wall_s=time.perf_counter() - t0, **log.PHASE_SECONDS))
        out = {"runs": runs}
        if profile:
            out["profile"] = device_profile(lambda: cli.main(argv),
                                            os.path.join(work, "trace.json"))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose gs2pc_torch is timed (default: this one)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--gaussians", type=int, default=3_000_000,
                    help="the capture scene's size; 0 times the probes alone")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--e2e", type=int, default=0,
                    help="also run the 16-camera conversion this many times")
    ap.add_argument("--profile", action="store_true",
                    help="with --e2e, profile one more conversion (card busy time)")
    ap.add_argument("--num_devices", type=int, default=None,
                    help="with --e2e, the CLI's --num_devices (default: the CLI's own)")
    ap.add_argument("--e2e_only", action="store_true",
                    help="with --e2e, skip the kernel and probe timings")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(kernels - set(KERNELS))}")
    if args.e2e_only:
        kernels = set()
    if not args.gaussians:
        kernels &= {"probes"}
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    import torch

    from gs2pc_torch.ops import cuda_build

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("bench_kernels times the card with CUDA events: it needs a CUDA device")
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    cuda_build.load_library()
    log = cuda_build.BUILD_INFO.get("log", "")
    rec = {"root": root, "device": torch.cuda.get_device_name(device),
           "build_s": time.perf_counter() - t0,
           **{f"{k}_ptxas": kernel_ptxas(log, name) for k, name in (
               ("k1", "blend_tiles_kernel"), ("k3", "probe_op_kernel"),
               ("k4", "probe_blend_kernel"), ("k5", "sample_points_kernel"),
               ("k6", "project_pack_kernel"), ("ply", "ply_decode_kernel"))}}
    if "probes" in kernels:
        rec["probes"] = time_probes(device, 10 * args.reps)
    if kernels & {"k1", "k2"}:
        prep, cfg, modes = camera_inputs(args.gaussians, device)
        from gs2pc_torch.ops import blend_kernel as B

        chunks = B.blend_tiles(*modes["main"][0], **modes["main"][1]).chunks.double()
        rec["chunks"] = {"mean": float(chunks.mean()),
                         "p99": float(torch.quantile(chunks, 0.99)),
                         "max": float(chunks.max())}
        if "k1" in kernels:
            rec["k1"] = time_k1(modes, args.reps)
        if "k2" in kernels:
            rec["k2"] = time_k2(prep, cfg, args.reps)
        del prep, modes
    if "k5" in kernels:
        rec["k5"] = time_k5(args.gaussians, device, args.reps)
    if "k6" in kernels:
        rec["k6"] = time_k6(args.gaussians, device, args.reps)
    if "ply" in kernels:
        rec["ply"] = time_ply_decode(device, args.reps)
    if args.e2e and args.gaussians:
        extra = [] if args.num_devices is None else ["--num_devices", str(args.num_devices)]
        rec["cards"] = torch.cuda.device_count()
        rec["e2e"] = time_e2e(root, args.gaussians, args.e2e, args.profile, extra)
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return rec


if __name__ == "__main__":
    main()
