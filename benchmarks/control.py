"""The control of the check that decides ``correct``: the plain reference
put in the program's place at TF32 precision (every operand rounded to a
10-bit mantissa), its cloud written as the program writes one and judged by
the cell's own comparison (gsbench.harness.judge, with the cell's check
file).  The cell's numbers have to call it wrong.  Not run by the
benchmark's runs.

    python3 benchmarks/control.py --workload <name> --seed <n> [--seed <n> ...]

on a card, at the cell's own size: per seed the scene is made and written as
a run makes it; the TF32 reference renders the Gaussians of the check's
uniform draw, then further draws of 4,096 until it keeps as many as the
check's in-cloud draw takes; its counts, colours and points of those
Gaussians go into a PLY, which is judged; one JSON line a seed is printed,
each number beside its limit, and ``ok``.  The cloud holds the rendered
Gaussians' points only, so ``budget_off`` is not read.
"""

import json
import os
import sys
import tempfile
import time

# Gaussians rendered at once beyond the check's uniform draw.
BLOCK = 4096


def control_cloud(scene: dict, scene_tf: dict, ids, counts, normals, colours, std: float,
                  seed: int) -> dict:
    """The control's rows for the Gaussians ``ids`` (ascending) with
    ``counts`` points each, in the program's layout: a run a Gaussian, its
    centre (copied from the export) first, the rest drawn uniformly inside
    its truncation ellipsoid from TF32 operands; one normal and one colour a
    run."""
    import torch

    from gsbench import reference as ref

    dev = ids.device
    g = torch.repeat_interleave(ids, counts)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(g.shape[0], device=dev) - torch.repeat_interleave(first, counts)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    d = torch.randn((g.shape[0], 3), generator=gen, device=dev)
    r = std * torch.rand(g.shape[0], generator=gen, device=dev) ** (1.0 / 3.0)
    z = torch.where((rank > 0)[:, None], d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
                    * r[:, None], 0.0)
    M = ref.round_tf32(ref.rotations(scene_tf["rots"][g])
                       * torch.exp(scene_tf["log_scales"][g])[:, None, :])
    pts = scene["xyz"][g] + torch.einsum("nij,nj->ni", M, ref.round_tf32(z))
    per = torch.repeat_interleave(torch.arange(ids.shape[0], device=dev), counts)
    return dict(points=pts, normals=normals[per], colours=colours[per])


def write_cloud(path: str, cloud: dict) -> None:
    """A binary little-endian PLY of the program's cloud layout."""
    import numpy as np

    from gsbench import reference as ref

    dt = np.dtype([(p, "<f4" if t == "float" else "u1") for p, t in ref.CLOUD_PROPS])
    n = cloud["points"].shape[0]
    rows = np.empty(n, dtype=dt)
    for key, names in (("points", "xyz"), ("normals", ("nx", "ny", "nz")),
                       ("colours", ("red", "green", "blue"))):
        arr = cloud[key].cpu().numpy()
        for i, name in enumerate(names):
            rows[name] = arr[:, i]
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    head += [f"property {t} {p}" for p, t in ref.CLOUD_PROPS] + ["end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode("ascii"))
        rows.tofile(fh)


def control_run(config: dict, traffic: dict, check: dict, seed: int, device) -> dict:
    """Make the cell's scene for ``seed``, put the TF32 reference in the
    program's place and judge its cloud by the cell's check.  Returns the
    judge's verdict with the Gaussians rendered and kept, the points
    written and the seconds taken."""
    import torch

    from gsbench import harness
    from gsbench import reference as ref
    from gsbench import scene as scene_mod

    device = torch.device(device)
    flags = traffic["flags"]

    def flag(name, default):
        return flags[flags.index(name) + 1] if name in flags else default

    torch.backends.cuda.matmul.allow_tf32 = False
    threshold = float(flag("--visibility_threshold", 0.05))
    std = float(flag("--mahalanobis_distance_std", 2.0))
    run_cap = int(flag("--max_pairs_per_tile", 4096))
    num_points = int(flag("--num_points", harness.NUM_POINTS))
    want = int(check["sample"]["in_cloud"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gs2pc-control-") as work:
        files = scene_mod.write_capture(work, config, seed, device)
        scene = ref.read_export(files["scene"], device)
        scene_tf = ref.read_export(files["scene"], device, ref.round_tf32)
        cams = ref.read_cameras(files["transforms"], int(flag("--camera_skip_rate", 0)),
                                flag("--colour_quality", "high"), device, ref.round_tf32)
        n = scene["xyz"].shape[0]
        # The check's uniform draw, then blocks of a second draw of the
        # rest, until the control keeps as many as the in-cloud draw takes.
        uniform = ref.sample_ids(n, int(check["sample"]["uniform"]), seed, device)
        rest = torch.ones(n, dtype=torch.bool, device=device)
        rest[uniform] = False
        rest = rest.nonzero()[:, 0]
        gen = torch.Generator()
        gen.manual_seed((int(seed) * 2654435761 + 13) % (1 << 63))
        rest = rest[torch.randperm(rest.shape[0], generator=gen).to(device)]
        blocks, kept, at = [uniform], 0, 0
        parts = {k: [] for k in ("ids", "max_w", "total", "colour")}
        while blocks:
            ids = torch.sort(blocks.pop())[0]
            res = ref.sweep_sample(scene_tf, cams, ids, run_cap, ref.round_tf32)
            for k, v in (("ids", ids), ("max_w", res["max_w"]), ("total", res["total"]),
                         ("colour", res["colour"])):
                parts[k].append(v)
            kept += int((res["max_w"] > threshold).sum())
            if kept < want and at < rest.shape[0]:
                blocks.append(rest[at:at + BLOCK])
                at += BLOCK
        ids, order = torch.sort(torch.cat(parts["ids"]))
        max_w, total = torch.cat(parts["max_w"])[order], torch.cat(parts["total"])[order]
        colour = torch.cat(parts["colour"])[order]
        t_sweep = time.perf_counter() - t0
        # Quotas as the budget sets them: the rendered Gaussians are a uniform
        # draw, so their mean size x summed weight over the kept stands for
        # every Gaussian's; a kept Gaussian gets its centre at least.
        keep = max_w > threshold
        m = ref.sizes(scene_tf)[ids] * total.double()
        lam = num_points * ids.shape[0] / (n * max(float(m[keep].sum()), 1e-30))
        counts = torch.where(keep, torch.clamp(torch.round(lam * m), min=1.0), 0.0).long()
        cloud = control_cloud(scene, scene_tf, ids[keep], counts[keep],
                              ref.normals(scene_tf)[ids[keep]],
                              torch.clamp(colour[keep] * 255.0, 0.0, 255.0).to(torch.uint8),
                              std, seed)
        ply = os.path.join(work, "control.ply")
        write_cloud(ply, cloud)
        points = int(cloud["points"].shape[0])
        del cloud, scene, scene_tf
        t1 = time.perf_counter()
        verdict = harness.judge(files, [ply], 1, traffic, check, seed, device, budget=False)
    return dict(ok=verdict["ok"], checks=verdict["checks"], judged=verdict["judged"],
                rendered=int(ids.shape[0]), kept=int(keep.sum()), points=points,
                control_s=t_sweep, judge_s=time.perf_counter() - t1)


def main(argv) -> int:
    import argparse

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:0] = [here, root]
    import torch

    from gsbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 3
    spec = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    _, config, traffic, check = harness.cell_files(spec, args.workload, root)
    for seed in args.seed:
        out = control_run(config, traffic, check, seed, "cuda:0")
        out.update(seed=seed, workload=args.workload)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
