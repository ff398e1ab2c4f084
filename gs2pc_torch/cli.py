"""CLI entry point: the command line of ``python -m gs2pc`` (parsed by the
shared gs2pc.utils.config), run on one CUDA device."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from gs2pc.utils.config import build_parser, parse_args, settings_from_args
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.pipeline import (
    Conversion,
    check_supported,
    convert_3dgs_to_pc,
    raise_not_ported,
)
from gs2pc_torch.utils import log

# Flags that only tune the TPU build: accepted, and a warning says they do
# nothing here.
TPU_ONLY_FLAGS = (
    "pallas", "pair_budget", "tile_slots", "tile_slots_small", "big_window_cap",
    "dispatch_cameras", "sampler_device",
)


def check_flags(args) -> None:
    """Warn about TPU-only flags; refuse flags whose feature is not ported."""
    parser = build_parser()
    for name in TPU_ONLY_FLAGS:
        if getattr(args, name) != parser.get_default(name):
            log.warn(f"--{name} tunes the TPU build only; it does nothing in gs2pc_torch")
    refused = (
        (args.clean_pointcloud, "--clean_pointcloud", 4),
        (args.num_devices > 1, "--num_devices above 1", 6),
        (args.profile_dir is not None, "--profile_dir", 8),
    )
    for given, flag, item in refused:
        if given:
            raise_not_ported(flag, item)


def main(argv: Optional[Sequence[str]] = None) -> Conversion:
    args = parse_args(argv)
    settings = settings_from_args(args)
    log.set_quiet(settings.quiet)
    check_flags(args)
    check_supported(settings)
    if not torch.cuda.is_available():
        sys.exit("gs2pc_torch: no CUDA device is available; the port runs on one GPU "
                 "(use python -m gs2pc on other machines)")
    result = convert_3dgs_to_pc(
        args.input_path, args.transform_path, args.mask_path, settings,
        device=torch.device("cuda", 0),
    )
    log.info("Saving Final Point Cloud")
    with log.phase("ply_write"):
        writer = save_point_cloud_ply(result.cloud, args.output_path, chunk_size=10**6)
    log.info(f"Wrote {result.cloud.total:,} points to {args.output_path} ({writer} writer)")
    return result


if __name__ == "__main__":
    main()
