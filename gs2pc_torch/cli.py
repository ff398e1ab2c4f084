"""CLI entry point: the command line of ``python -m gs2pc`` (parsed by the
port's copy of its parser, gs2pc_torch.utils.config), run on CUDA devices:
``cuda:0`` for everything, and ``cuda:0 .. cuda:N-1`` for the camera sweep
with ``--num_devices N`` (0, the default, means every card) on the axis
``--shard_axis cams|gauss|both`` names, one process per card over NCCL
(this process is rank 0 and runs everything else).  ``--profile_dir DIR`` writes a
torch.profiler Chrome trace of the conversion (CPU and CUDA activities,
the pipeline phases as named ranges) to DIR/TRACE_NAME.  After the
conversion, as in ``python -m gs2pc``: ``--clean_pointcloud`` removes the
statistical outliers on the card, the cloud is written, and
``--generate_mesh`` meshes the surface point cloud into
``--mesh_output_path``."""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator, Optional, Sequence

import torch

from gs2pc_torch.utils.config import build_parser, parse_args, settings_from_args
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.meshing import clean_point_cloud, generate_mesh
from gs2pc_torch.pipeline import Conversion, convert_3dgs_to_pc
from gs2pc_torch.utils import log

# Flags that only tune the TPU build: accepted, and a warning says they do
# nothing here.
TPU_ONLY_FLAGS = (
    "pallas", "pair_budget", "tile_slots", "tile_slots_small", "big_window_cap",
    "dispatch_cameras", "sampler_device",
)


def check_flags(args) -> None:
    """Warn about TPU-only flags."""
    parser = build_parser()
    for name in TPU_ONLY_FLAGS:
        if getattr(args, name) != parser.get_default(name):
            log.warn(f"--{name} tunes the TPU build only; it does nothing in gs2pc_torch")


TRACE_NAME = "gs2pc_torch_trace.json"


@contextlib.contextmanager
def profiling(profile_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with torch.profiler (CPU activities, and CUDA ones
    where there is a card) and write it as a Chrome trace into
    ``profile_dir``; nothing when it is None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    log.info(f"Profiler trace written to {path}")


def main(argv: Optional[Sequence[str]] = None) -> Conversion:
    args = parse_args(argv)
    settings = settings_from_args(args)
    log.set_quiet(settings.quiet)
    check_flags(args)
    if not torch.cuda.is_available():
        sys.exit("gs2pc_torch: no CUDA device is available; the port runs on NVIDIA GPUs "
                 "(use python -m gs2pc on other machines)")
    device = torch.device("cuda", 0)
    with profiling(args.profile_dir):
        result = convert_3dgs_to_pc(
            args.input_path, args.transform_path, args.mask_path, settings,
            device=device, num_devices=args.num_devices,
        )
    if args.clean_pointcloud:
        log.info("Cleaning Point Cloud")
        with log.phase("clean_pointcloud"):
            result = result._replace(cloud=clean_point_cloud(result.cloud, device=device))
    log.info("Saving Final Point Cloud")
    with log.phase("ply_write"):
        writer = save_point_cloud_ply(result.cloud, args.output_path, chunk_size=10**6)
    log.info(f"Wrote {result.cloud.total:,} points to {args.output_path} ({writer} writer)")
    result = result._replace(writer=writer)
    if settings.generate_mesh:
        log.info("Generating Mesh")
        surface = result.surface_cloud
        mesh = generate_mesh(
            surface.points, surface.cols_u8[surface.gauss_ids()], surface.normals,
            args.mesh_output_path, depth=args.poisson_depth,
            laplacian_iters=args.laplacian_iterations, device=device,
        )
        log.info(f"Wrote a mesh of {len(mesh.verts):,} vertices and {len(mesh.faces):,} "
                 f"faces to {args.mesh_output_path} ({mesh.mesher})")
        result = result._replace(mesh=mesh)
    return result


if __name__ == "__main__":
    main()
