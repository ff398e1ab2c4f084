"""One run of one benchmark cell: make the scene from the seed, warm up,
convert scenes back to back through the program's CLI for a window of
``--seconds``, then judge what the window wrote against the plain
reference and print the cell's metrics as one JSON line.

Everything that belongs to one configuration, one traffic mix, one cell's
check or one metric is a file of its own, found by the names in
BENCHMARK.json:

- ``configs/<config>.json``: the scene's published shape and what was
  assumed (the ``file`` of the configuration's entry);
- ``traffic/<mix>.json``: the CLI flags of the mix;
- ``checks/<workload>.json``: the sample size and the limits of the
  numbers that decide ``correct``;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  metric from the run's record (RunRecord).
"""

from __future__ import annotations

import filecmp
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import NamedTuple, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "gs2pc")
# The CLI's point budget where a traffic mix names none.
NUM_POINTS = 10_000_000
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RunRecord(NamedTuple):
    """What a run measured, as the metric readers see it."""

    setup_s: float
    window_s: float
    conversions: list  # per conversion: {"wall_s", "phases", "sweep_diag"}
    peak_bytes: int
    n_gaussians: int
    renders: int  # cameras rendered by one conversion
    trace: Optional[object] = None  # gsbench.trace.Trace of the window
    window_ns: Optional[tuple] = None  # (start, end) of the traced window

    def phase_mean(self, *names: str) -> Optional[float]:
        """Seconds a conversion spent in the phases ``names``, averaged over
        the window's conversions."""
        if not self.conversions:
            return None
        return sum(sum(c["phases"].get(n, 0.0) for n in names)
                   for c in self.conversions) / len(self.conversions)


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_files(spec: dict, workload: str, root: str) -> tuple:
    """(cell, configuration, traffic, check) of ``workload`` in the
    benchmark ``spec``; raises StopIteration for an unknown name and
    OSError for a missing file."""
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))
    check = load_json(os.path.join(BENCH_DIR, "checks", f"{workload}.json"))
    return cell, config, traffic, check


def metric_reader(name: str):
    """``read`` of metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gsbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end without a trace, per-layer
    with one, each where its ``workloads`` (if given) name the cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def cli_argv(traffic: dict, files: dict, out: str, seed: int) -> list:
    """The CLI's command line of one conversion of the cell."""
    return ["--input_path", files["scene"], "--transform_path", files["transforms"],
            "--output_path", out, "--num_devices", "1", "--quiet",
            "--seed", str(int(seed) % (1 << 31)), *traffic["flags"]]


def renders_per_conversion(config: dict, traffic: dict) -> int:
    """Cameras one conversion renders: every (skip + 1)-th image."""
    flags = traffic["flags"]
    skip = int(flags[flags.index("--camera_skip_rate") + 1]) if "--camera_skip_rate" in flags \
        else 0
    return -(-int(config["images"]) // (skip + 1))


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_window(cli, log, argvs: list, seconds: float, device) -> dict:
    """Conversions back to back, each starting when the one before ends,
    until ``seconds`` have passed; the conversion under way then finishes
    and the window ends with it.  Returns the window's wall, the
    conversions' records and the failures."""
    import torch

    convs, failed, err = [], 0, None
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench_window"):
        while time.perf_counter() - t0 < seconds:
            log.reset_phases()
            c0 = time.perf_counter()
            try:
                with torch.profiler.record_function("bench_conversion"):
                    res = cli.main(argvs[len(convs) % 2])
            except Exception:  # a failed conversion ends the window and the run is wrong
                failed, err = 1, traceback.format_exc()
                break
            convs.append(dict(wall_s=time.perf_counter() - c0, phases=dict(log.PHASE_SECONDS),
                              sweep_diag=res.sweep_diag))
            del res
    window_s = time.perf_counter() - t0
    return dict(window_s=window_s, conversions=convs, failed=failed, error=err)


def judge(files: dict, outs: list, n_conv: int, traffic: dict, check: dict, seed: int,
          device, budget: bool = True) -> dict:
    """The numbers that decide ``correct``, each with its limit: the last
    conversion's cloud against the reference (gsbench.reference), its row
    count against the point budget (``budget_off``, left out when not
    ``budget``), and ``repeat_diff``, whether the conversion before it wrote
    other bytes."""
    import torch

    from gsbench import reference as ref

    flags = traffic["flags"]

    def flag(name, default):
        return flags[flags.index(name) + 1] if name in flags else default

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        parts[name] = time.perf_counter() - t
        t = time.perf_counter()

    last = outs[(n_conv - 1) % 2]
    nums = {"repeat_diff": 0.0}
    if n_conv >= 2:
        nums["repeat_diff"] = 0.0 if filecmp.cmp(outs[0], outs[1], shallow=False) else 1.0
    lap("repeat")
    scene = ref.read_export(files["scene"], device)
    cloud = ref.read_cloud(last, device)
    rows = int(cloud["points"].shape[0])
    lap("read")
    whole = ref.judge_cloud(cloud, scene, float(flag("--mahalanobis_distance_std", 2.0)))
    del cloud
    runs = int((whole["counts"] > 0).sum())
    if budget:
        nums["budget_off"] = ref.budget_off(rows, int(flag("--num_points", NUM_POINTS)), runs)
    lap("cloud")
    # Two samples drawn from the seed: of every Gaussian (does the cloud keep
    # the ones the reference keeps?) and of the Gaussians the cloud has
    # points of (their colours and counts).
    n = scene["xyz"].shape[0]
    uniform = ref.sample_ids(n, int(check["sample"]["uniform"]), seed, device)
    in_cloud = (whole["counts"] > 0).nonzero()[:, 0]
    in_cloud = in_cloud[ref.sample_ids(in_cloud.shape[0], int(check["sample"]["in_cloud"]),
                                       seed + 1, device)]
    ids = torch.unique(torch.cat([uniform, in_cloud]))
    cams = ref.read_cameras(files["transforms"], int(flag("--camera_skip_rate", 0)),
                            flag("--colour_quality", "high"), device)
    swept = ref.sweep_sample(scene, cams, ids, int(flag("--max_pairs_per_tile", 4096)))
    lap("sweep")
    threshold = float(flag("--visibility_threshold", 0.05))
    part = ref.judge_sample(swept, ref.sizes(scene)[ids], whole["counts"][ids],
                            whole["colours"][ids], threshold)
    for key in ("layout", "mahal_max", "normal_gap", "count_off", "colour_off"):
        nums[key] = whole[key] if key in whole else part[key]
    limits = check["limits"]
    checks = {key: {"value": v, "limit": limits[key]} for key, v in nums.items()}
    return dict(checks=checks, ok=all(v <= limits[key] for key, v in nums.items()),
                judged={"count": part["judged"], "colour": part["kept"], "rows": rows,
                        "gaussians": runs, "seconds": parts})


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, root: str,
             device=None, t_start: Optional[float] = None) -> dict:
    """One run of ``workload`` of the benchmark ``spec``: set-up, the
    window, the check.  Returns the result object.  ``device`` defaults to
    the first card."""
    return run_loaded(*cell_files(spec, workload, root), cell_metrics(spec, workload, trace),
                      seed, seconds, trace, device, t_start=t_start)


def run_loaded(cell: dict, config: dict, traffic: dict, check: dict, metric_entries: list,
               seed: int, seconds: float, trace: bool, device=None,
               t_start: Optional[float] = None) -> dict:
    """run_cell on the cell's loaded files and metric entries."""
    import torch

    from gs2pc_torch import cli
    from gs2pc_torch.utils import log
    from gsbench import scene as scene_mod
    from gsbench import trace as trace_mod

    device = torch.device(device or "cuda:0")
    workload = cell["name"]
    work = tempfile.mkdtemp(prefix=f"gs2pc-bench-{workload}-")
    try:
        files = scene_mod.write_capture(work, config, seed, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        outs = [os.path.join(work, f"cloud_{i}.ply") for i in range(2)]
        argvs = [cli_argv(traffic, files, o, seed) for o in outs]
        warm = time.perf_counter()
        try:
            cli.main(argvs[1])
            seconds_left = seconds
        except Exception:  # a failed warm conversion: no window, the run is wrong
            print(traceback.format_exc(), file=sys.stderr)
            seconds_left = 0.0
        warm = time.perf_counter() - warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = process_age() if t_start is None else time.perf_counter() - t_start

        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            win = run_window(cli, log, argvs, seconds_left, device)
            if seconds_left == 0.0:
                win.update(failed=1, error="the warm conversion failed")
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        tr, window_ns = None, None
        if prof is not None:
            tr = trace_mod.from_profiler(prof)
            del prof
            spans = tr.spans("bench_window")
            window_ns = (spans[0].start_ns, spans[0].end_ns) if spans else None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        record = RunRecord(
            setup_s=setup_s, window_s=win["window_s"],
            conversions=win["conversions"], peak_bytes=int(peak),
            n_gaussians=int(config["gaussians"]), renders=renders_per_conversion(config, traffic),
            trace=tr, window_ns=window_ns)
        n_conv = len(win["conversions"])
        verdict = None
        t_check = time.perf_counter()
        if win["failed"] == 0 and n_conv:
            verdict = judge(files, outs, n_conv, traffic, check, seed, device)
        t_check = time.perf_counter() - t_check

        metrics = {}
        for m in metric_entries:
            v = metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
        if tr is not None and window_ns is not None:
            lo, hi = window_ns
            dev["busy_s"] = trace_mod.union_seconds(tr.device, lo, hi)
            dev["window_s"] = (hi - lo) / 1e9
        if device.type == "cuda":
            dev["power_limit"] = power_limit()
        result = {
            "correct": bool(verdict and verdict["ok"]),
            "attempted": n_conv + win["failed"],
            "failed": win["failed"],
            "metrics": metrics,
            "device": dev,
            "walls_s": [c["wall_s"] for c in win["conversions"]],
            "phases_s": {k: record.phase_mean(k) for k in sorted(
                {p for c in win["conversions"] for p in c["phases"]})},
            "warm_s": warm,
            "check_s": t_check,
            "judged": verdict and verdict["judged"],
        }
        if tr is not None and window_ns is not None:
            lo, hi = window_ns
            gaps = trace_mod.idle_gaps(tr.device, tr.ranges, lo, hi, skip=("bench_window",))
            result["breakdown"] = {
                "device_ops": trace_mod.top_ops(tr.device, lo, hi),
                "idle_gaps": [["outside the phases" if n == "bench_conversion" else n, s]
                              for n, s in gaps]}
        if win["error"]:
            result["error"] = win["error"][-2000:]
        result["checks"] = verdict["checks"] if verdict else {}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not have loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, root: str, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="One run of one cell of the gs2pc_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    try:
        cell_files(spec, args.workload, root)
    except (StopIteration, OSError) as e:
        print(f"unknown workload or missing files for {args.workload!r}: {e}", file=sys.stderr)
        return 2
    try:
        import torch

        import gs2pc_torch.cli  # noqa: F401  (the program under test must be there)
    except ImportError as e:
        print(f"cannot import the program under test: {e}", file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), root,
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
