"""Multi-device dry run (counterpart of __graft_entry__.dryrun_multichip):
every sharded axis of the port on a tiny seeded scene, each held to the
one-device run, with one verdict line per axis.

    python -m gs2pc_torch.parallel.dryrun [--devices 8] [--device cuda:0]

The JAX package re-executes itself on a virtual CPU mesh and runs its
``shard_map`` programs there; here the devices are a list, ``[device] * n``
(a split on one card or on the CPU), or the first n cards for a bare
``cuda``, and each split runs twice: as the one-thread walk, and as the
SPMD program, one process per device (gs2pc_torch.parallel.launch; gloo
for a repeated device, NCCL over distinct cards), which must equal the
walk bit for bit.  Four phases, as in the JAX dry run: the camera split,
the sampler (4096 points, n_cap 8192, from the camera split's
contributions), the depth-slab sweep and, for n >= 4, the 2-D sweep.  Each
sweep prints the largest absolute difference of every accumulator from
the one-device run and raises when it differs beyond its bound: the
camera split is exact (the total contribution within f32 summation
order); the depth-slab and 2-D sweeps
are held to tests/test_sharding.py's bounds, with their drop counters
equal (their pairs-blended count differs: slab passes 1-2 blend with the
adaptive radius, as in the JAX package).  The sampler's point axis is
split over the SPMD ranks, as the JAX dry run shards it
(gs2pc_torch.pipeline.sample_on_axis); its phase checks what the JAX dry
run checks, more than 1000 valid points, and that they are finite and
equal to one device's bit for bit.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import prng
from gs2pc_torch.ops.blend import FLOAT_MAX
from gs2pc_torch.ops.rasterize import TileConfig
from gs2pc_torch.ops.sampler import distribute_points, sample_points
from gs2pc_torch.parallel import gauss_shard, launch, mesh
from gs2pc_torch.parallel.group import backend_for
from gs2pc_torch.pipeline import SamplingJob, sample_on_axis
from gs2pc_torch.sweep import (
    broadcast_sweep_inputs,
    render_arrays,
    render_sweep,
    render_sweep_sharded,
    render_sweep_spmd,
)
from gs2pc_torch.utils import log

N_GAUSSIANS = 256
SIZE = 64
N_POINTS = 4096
N_CAP = 8192
MIN_VALID = 1000
# Bounds against one device: f32 summation order for the total (and, in
# the depth-slab sweeps, every sum), argmax-pixel ties for the colour
# (tests/test_sharding.py's).
TOL_TOTAL = 1e-5
TOL_CONTRIB = 1e-5
TOL_SURF = 1e-4
TOL_COLOUR = 1e-3
COLOUR_SHARE = 0.97
ACCUMULATORS = ("max_contribution", "colours", "total_contribution", "min_surface_distance",
                "n_dropped")
# Each split (--shard_axis) as a walk and as an SPMD program.
WALKS = {"cams": render_sweep_sharded, "gauss": gauss_shard.render_sweep_gauss_sharded,
         "both": gauss_shard.render_sweep_2d}
SPMD = {"cams": render_sweep_spmd, "gauss": gauss_shard.render_sweep_gauss_spmd,
        "both": gauss_shard.render_sweep_2d_spmd}


def sweep_rank(axis, split: str, cfg: TileConfig, root=None):
    """A rank function (gs2pc_torch.parallel.launch.run): rank 0's ``root``
    = (RenderArrays, CameraBatch, SH or None) broadcast, then the SPMD
    sweep of ``split``.  Rank 0 returns (accumulators, wall seconds of the
    sweep with the card synchronised, [K1, K2] launches of each rank)."""
    with log.phase("scene_broadcast"):
        scene, cams, sh = broadcast_sweep_inputs(axis, root)
    before = _launches()
    _sync(axis.device)
    t0 = time.perf_counter()
    acc = SPMD[split](scene, cams, cfg, axis, sh=sh)
    _sync(axis.device)
    wall = time.perf_counter() - t0
    launches = axis.all_gather(torch.tensor(_launches()) - torch.tensor(before))
    return acc, wall, launches.tolist()


def _launches() -> list:
    counts = launch.kernel_launches()
    return [counts["blend_tiles"], counts["duplicate_with_keys"]]


class PlantedFailure(RuntimeError):
    """The error fail_on_rank raises."""


def fail_on_rank(axis, rank: int, root=None) -> None:
    """A rank function that fails on purpose, to check the launcher's
    failure path: every rank joins one all_gather, then rank ``rank``
    raises PlantedFailure while the others wait on it in a second."""
    axis.all_gather(torch.zeros(1, device=axis.device))
    if axis.rank == rank:
        raise PlantedFailure(f"planted on rank {rank} of {axis.size}")
    axis.all_gather(torch.zeros(1, device=axis.device))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tiny_scene(n: int = N_GAUSSIANS, seed: int = 0, *, device) -> Gaussians:
    """__graft_entry__._tiny_scene's seeded scene."""
    r = np.random.default_rng(seed)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return Gaussians.from_numpy(
        r.uniform(-1, 1, (n, 3)).astype(np.float32),
        r.uniform(-3.5, -1.5, (n, 3)).astype(np.float32),
        quats,
        r.uniform(0, 1, (n, 3)).astype(np.float32),
        r.uniform(0.3, 1.0, n).astype(np.float32),
        device=device,
    )


def tiny_cameras(n_cams: int, width: int = SIZE, height: int = SIZE, focal: float = 80.0, *,
                 device):
    """__graft_entry__._tiny_cameras: a ring at radius 4 looking at the origin."""
    transforms, intr = {}, {}
    for i in range(n_cams):
        angle = i * (2 * np.pi / max(n_cams, 1))
        c = np.array([4.0 * np.sin(angle), 0.0, -4.0 * np.cos(angle)])
        z = -c / np.linalg.norm(c)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, c
        c2w[:, 1:3] = -c2w[:, 1:3]
        transforms[f"c{i}"] = c2w.tolist()
        intr[f"c{i}"] = (width, height, focal, focal)
    return build_camera_batch(transforms, intr, device=device)


def accumulator_diffs(acc, ref) -> dict:
    """Largest |acc - ref| of each accumulator; the surface distance over
    Gaussians finite on both sides, and where it is finite on one side only
    the difference is infinite."""
    out = {}
    for name in ACCUMULATORS:
        a, b = getattr(acc, name), getattr(ref, name)
        if name == "min_surface_distance":
            fa, fb = a < FLOAT_MAX, b < FLOAT_MAX
            if not torch.equal(fa, fb):
                out[name] = float("inf")
                continue
            a, b = a[fa], b[fb]
        out[name] = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    return out


def _exact_ok(d: dict) -> bool:
    return all(v == 0.0 for k, v in d.items() if k != "total_contribution") and \
        d["total_contribution"] <= TOL_TOTAL


def _slab_ok(d: dict, acc, ref) -> bool:
    share = float(((acc.colours - ref.colours).abs().amax(dim=1) < TOL_COLOUR).float().mean())
    return (d["max_contribution"] <= TOL_CONTRIB and d["total_contribution"] <= TOL_CONTRIB
            and d["min_surface_distance"] <= TOL_SURF and share > COLOUR_SHARE
            and torch.equal(acc.n_dropped[1:], ref.n_dropped[1:]))


def _diff_text(diffs: dict) -> str:
    return ", ".join(f"{k} {v}" if isinstance(v, int) else f"{k} {v:.3g}"
                     for k, v in diffs.items())


def _verdict(n: int, axis: str, ok: bool, diffs: dict, spmd: str = "") -> str:
    verdict = "OK" if ok else "DIFFERS"
    what = "split over the SPMD ranks" if axis == "points" else "max |d| vs one device"
    return f"dryrun_multichip({n}) {axis}: {verdict}; {what}: {_diff_text(diffs)}{spmd}"


def dryrun_multichip(n_devices: int, device="cuda:0") -> dict:
    """Run every sharded axis on ``[device] * n_devices`` (the first n cards
    for a bare ``cuda``) against one device, as the one-thread walk and as
    the SPMD program (one process per device, gs2pc_torch.parallel.launch);
    print one verdict line per axis, the SPMD program's beside the walk's,
    and return {axis: the walk's max |d| by accumulator}.  The SPMD sweep
    must equal the walk bit for bit.  Raises ValueError naming every axis
    that differs."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        devices = mesh.devices(n_devices)
    else:
        devices = [device] * n_devices
    home = devices[0]
    g = tiny_scene(device=home)
    scene = render_arrays(g)
    cams = tiny_cameras(max(n_devices, 2), device=home)
    cfg = TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    one = render_sweep(scene, cams, cfg)
    splits = {"cams": "cams", "gauss": "gauss"}
    if n_devices >= 4:
        splits["2-D"] = "both"
    walks = {axis: WALKS[split](scene, cams, cfg, devices) for axis, split in splits.items()}
    ppg = distribute_points(g.magnitudes(contributions=walks["cams"].total_contribution),
                            N_POINTS)
    job = SamplingJob(key=prng.PRNGKey(0).tolist(), n_cap=N_CAP, std=2.0, max_points=None)
    spmd = launch.run(launch.in_turn, devices,
                      [(sweep_rank, (s, cfg)) for s in splits.values()]
                      + [(sample_on_axis, (job,))],
                      root=[(scene, cams, None)] * len(splits)
                      + [(ppg, g.xyz, g.log_scales, g.rots)])
    split_points = spmd.pop()
    spmd = {axis: acc for axis, (acc, _, _) in zip(splits, spmd)}
    backend = backend_for(devices)

    verdicts, failed = {}, []

    def report(axis, ok, diffs, spmd_note=""):
        verdicts[axis] = diffs
        print(_verdict(n_devices, axis, ok, diffs, spmd_note), flush=True)
        if not ok:
            failed.append(axis)

    def held(axis, acc):
        d = accumulator_diffs(acc, one)
        return (_exact_ok(d) if axis == "cams" else _slab_ok(d, acc, one)), d

    for axis in splits:
        ok, d = held(axis, walks[axis])
        s_ok, s_d = held(axis, spmd[axis])
        same = all(torch.equal(getattr(spmd[axis], k), getattr(walks[axis], k))
                   for k in ACCUMULATORS)
        note = (f"; SPMD over {n_devices} processes ({backend}): "
                f"{'OK' if s_ok else 'DIFFERS'}, "
                f"{'bit-equal to' if same else 'DIFFERS from'} the walk")
        if not same:
            note += f"; SPMD max |d| vs one device: {_diff_text(s_d)}"
        report(axis, ok and s_ok and same, d, note)
        if axis == "cams":
            one_pts = sample_points(torch.tensor(job.key), g, ppg, n_cap=N_CAP).points
            n_valid, finite = split_points.shape[0], int(torch.isfinite(split_points).all())
            same = int(torch.equal(split_points, one_pts))
            report("points", n_valid > MIN_VALID and finite == 1 and same == 1,
                   {"valid": n_valid, "finite": finite, "bit-equal to one device": same})
    if failed:
        raise ValueError(f"dryrun_multichip({n_devices}): {', '.join(failed)} differ from "
                         "one device or from the walk")
    return verdicts


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8, help="the number of devices")
    ap.add_argument("--device", default="cuda:0",
                    help="repeated --devices times; a bare 'cuda' takes the first cards")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
