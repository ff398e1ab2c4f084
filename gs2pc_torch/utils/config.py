"""Settings objects + CLI/config-file parsing (a copy of gs2pc.utils.config).

The port keeps its own copy so that it imports nothing of the JAX package;
the parser, its validation and the settings are the same flag for flag, so
one command line drives ``python -m gs2pc`` and ``python -m gs2pc_torch``
(tests/test_torch_io_copies.py pins the two against each other).  Flags
that tune only the TPU build parse here and are warned about by
gs2pc_torch.cli.

Flag-for-flag parity with the reference CLI (gauss_to_pc.py:603-710),
including every cross-flag validation rule.  The reference uses
configargparse for optional config-file support; that package is not a
dependency here, so an equivalent ``--config FILE`` layer (one ``key = value``
or ``key: value`` per line, '#' comments) is built on argparse directly.
"""

from __future__ import annotations

import argparse
import shlex
from typing import NamedTuple, Optional, Sequence

# gauss_to_pc.py:24
COLOR_QUALITY_OPTIONS = {
    "tiny": 180,
    "low": 360,
    "medium": 720,
    "high": 1280,
    "ultra": 1920,
    "original": None,
}


class RenderConfig(NamedTuple):
    """Static knobs of the tile renderer.

    These replace the reference CUDA build-time constants (config.h:16-17:
    16x16 tiles, 256-Gaussian batches) and the python renderer's
    memory-pressure heuristics (gauss_render.py:439-465).  The port reads
    max_pairs_per_tile, run_chunk, compact_pairs and surface_compact; the
    others size the JAX package's static buffers.
    """

    tile: int = 16  # pixel tile edge
    slots_per_gaussian: int = 16  # legacy pair-budget input (see TileConfig)
    slots_small: int = 4  # legacy pair-budget input (see TileConfig)
    big_cap: int = 0  # legacy pair-budget input (0 = P // 4)
    pair_budget: int = 0  # splat-tile pair capacity per camera (0 = derive)
    max_pairs_per_tile: int = 4096  # per-tile run cap (front-to-back)
    run_chunk: int = 128  # gaussians blended per inner step
    tile_batch: int = 256  # tiles processed per outer step
    use_pallas: str = "auto"  # "auto" | "on" | "off" — Pallas blend kernel
    dispatch_cams: int = 0  # cameras per jit dispatch (0 = auto-size)
    # Compact 8-lane blend-table rows (rgb quantized to the output's own
    # 8-bit precision); halves per-pair gather/DMA traffic.  Off = exact
    # f32 colours through the blend (oracle-parity mode).
    compact_pairs: bool = True
    # Surface-distance early-exit compaction: reproduce the reference's
    # block-level break (forward.cu:369-371 — once every pixel in a tile
    # is done, the surface pass stops too) so occluded tail pairs never
    # enter the surface min and the kernel skips their DMA sweep.  Off =
    # min over every capped run pair (dense-renderer semantics).
    surface_compact: bool = True


class GaussPointCloudSettings(NamedTuple):
    """Pipeline settings (parity: gauss_to_pc.py:26-60, 20 fields)."""

    renderer_type: str = "tile"
    num_points: int = 10_000_000
    prioritise_visible_gaussians: bool = True
    mahalanobis_distance_std: float = 2.0
    camera_skip_rate: int = 0
    render_colours: bool = True
    min_opacity: float = 0.0
    bounding_box_min: Optional[list] = None
    bounding_box_max: Optional[list] = None
    calculate_normals: bool = True
    cull_large_percentage: float = 0.0
    remove_unrendered_gaussians: bool = True
    colour_resolution: Optional[int] = 1280
    max_sh_degree: int = 3
    exact_num_points: bool = False
    visibility_threshold: float = 0.05
    surface_distance_std: Optional[float] = None
    generate_mesh: bool = False
    quiet: bool = False
    seed: int = 0
    sh_colour_eval: bool = False  # full view-dependent SH during the sweep
    save_sweep: Optional[str] = None  # checkpoint accumulators after sweep
    load_sweep: Optional[str] = None  # resume accumulators, skip the sweep
    shard_axis: str = "cams"  # "cams" | "gauss" (depth slabs) | "both" (2-D)
    auto_capacity: bool = False  # grow tile capacities + re-sweep on truncation
    sampler_device: str = "auto"  # "auto" | "device" | "host" (see pipeline)
    render: RenderConfig = RenderConfig()


# Renderer aliases: the reference exposes "cuda" (native tile rasterizer)
# and "python" (dense fallback).  gs2pc's equivalents are "tile" and
# "dense"; reference names are accepted as drop-in aliases.
RENDERER_ALIASES = {
    "cuda": "tile",
    "tile": "tile",
    "python": "dense",
    "dense": "dense",
}

_TRUE_WORDS = ("true", "yes", "on", "1")
_FALSE_WORDS = ("false", "no", "off", "0")


def _read_config_file(
    path: str, parser: argparse.ArgumentParser
) -> list[str]:
    """Parse a key=value / key: value config file into argv tokens.

    Boolean interpretation applies ONLY to keys that are store_true flags
    on ``parser`` — value-taking flags pass their text through verbatim, so
    e.g. ``pallas = off`` reaches argparse as ``--pallas off`` rather than
    being swallowed as a boolean.  Later lines override earlier ones for
    the same key (so ``key = false`` cancels an earlier ``key = true``),
    and explicit CLI flags override the file.
    """
    flag_keys = {
        a.dest
        for a in parser._actions
        if isinstance(a, argparse._StoreTrueAction)
    }
    entries: dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, value = line.split("=", 1)
            elif ":" in line:
                key, value = line.split(":", 1)
            else:
                key, value = line, ""
            key = key.strip().lstrip("-").replace("-", "_")
            entries[key] = value.strip()

    argv: list[str] = []
    for key, value in entries.items():
        if key in flag_keys:
            word = value.lower()
            if word in _TRUE_WORDS or word == "":
                argv.append(f"--{key}")
            elif word in _FALSE_WORDS:
                continue
            else:
                raise AttributeError(
                    f"Config entry '{key} = {value}' must be a boolean "
                    f"(one of {_TRUE_WORDS + _FALSE_WORDS})"
                )
        else:
            argv.append(f"--{key}")
            argv.extend(shlex.split(value))
    return argv


def build_parser() -> argparse.ArgumentParser:
    """CLI surface, flag-for-flag with gauss_to_pc.py:603-646."""
    p = argparse.ArgumentParser(
        prog="gs2pc_torch",
        description="3D Gaussian Splatting to point cloud converter (PyTorch / CUDA)",
    )
    p.add_argument("--config", type=str, default=None, help="Read defaults from a key=value config file; flags given on the command line take precedence")

    p.add_argument("--input_path", type=str, required=True, help="The 3DGS scene to convert (.ply or .splat)")
    p.add_argument("--output_path", type=str, default="3dgs_pc.ply", help="Where to write the generated point cloud (a .ply file)")
    p.add_argument("--transform_path", default=None, type=str, help="Camera poses for the colour render sweep: a COLMAP sparse directory (bin/txt) or a transforms.json file")
    p.add_argument("--mask_path", default=None, type=str, help="Directory of per-image masks; file names must line up with the image names in the transforms")
    p.add_argument("--renderer_type", type=str, default="tile", help="Which renderer colours the points: 'tile' (TPU tile rasterizer; alias 'cuda') or 'dense' (exact dense oracle; alias 'python')")
    p.add_argument("--num_points", type=int, default=10_000_000, help="Target size of the output point cloud")
    p.add_argument("--exact_num_points", action="store_true", help="Drive the generated count as close to --num_points as possible (costs extra sampling work)")
    p.add_argument("--no_prioritise_visible_gaussians", action="store_true", help="By default the point budget is weighted towards Gaussians that contribute most across the rendered views; pass this to weight by size alone")
    p.add_argument("--visibility_threshold", type=float, default=0.05, help="Drop Gaussians whose best per-view contribution never reaches this value (raise to suppress floaters)")
    p.add_argument("--surface_distance_std", type=float, default=None, help="Drop Gaussians further than this many deviations from the rendered surface depth (lower = tighter to the surface)")
    p.add_argument("--clean_pointcloud", action="store_true", help="Run statistical outlier removal on the finished cloud")
    p.add_argument("--generate_mesh", action="store_true", help="Additionally reconstruct a mesh from a surface-biased point cloud")
    p.add_argument("--poisson_depth", default=10, type=int, help="Octree depth for Poisson surface reconstruction (deeper = finer mesh, slower)")
    p.add_argument("--laplacian_iterations", default=10, type=int, help="Rounds of Laplacian smoothing applied to the reconstructed mesh")
    p.add_argument("--mesh_output_path", type=str, default="3dgs_mesh.ply", help="Where to write the reconstructed mesh (a .ply file)")
    p.add_argument("--camera_skip_rate", type=int, default=0, help="Render every (N+1)-th camera only; useful when poses follow a dense trajectory")
    p.add_argument("--no_render_colours", action="store_true", help="Skip the colour render sweep entirely (much faster; points keep their raw Gaussian colours)")
    p.add_argument("--colour_quality", type=str, default="high", help="Resolution tier for the colour render sweep: tiny, low, medium, high, ultra, or original (native image size)")
    p.add_argument("--bounding_box_min", nargs=3, help="Lower corner (x y z) of an axis-aligned crop applied before sampling")
    p.add_argument("--bounding_box_max", nargs=3, help="Upper corner (x y z) of an axis-aligned crop applied before sampling")
    p.add_argument("--mahalanobis_distance_std", type=float, default=2.0, help="Truncation radius for sampling, in standard deviations from each Gaussian's centre")
    p.add_argument("--no_calculate_normals", action="store_true", help="Skip per-point normals (they come from each Gaussian's flattest axis)")
    p.add_argument("--min_opacity", type=float, default=0.0, help="Drop Gaussians below this opacity (range 0-1)")
    p.add_argument("--cull_gaussian_sizes", type=float, default=0.0, help="Drop this percentage of Gaussians, largest first (tames oversized background splats)")
    p.add_argument("--max_sh_degree", type=int, default=3, help="Spherical-harmonic degree of the input scene (only change for non-standard exports)")
    p.add_argument("--quiet", action="store_true", help="Silence progress output")

    # gs2pc-specific extensions (all optional, defaults match reference flow)
    p.add_argument("--seed", type=int, default=0, help="PRNG seed for point sampling")
    p.add_argument("--pair_budget", type=int, default=0, help="Static splat-tile pair capacity per camera in the tile renderer; per-Gaussian tile coverage is waterfilled to fit it (0 = derive from the tile-slot knobs, 8 pairs per Gaussian at their defaults). Raise if truncation warnings appear")
    p.add_argument("--tile_slots", type=int, default=16, help="Legacy pair-budget input (the derived budget is tile_slots_small per Gaussian plus tile_slots for each of big_window_cap Gaussians); prefer --pair_budget")
    p.add_argument("--tile_slots_small", type=int, default=4, help="Legacy pair-budget input; prefer --pair_budget")
    p.add_argument("--big_window_cap", type=int, default=0, help="Legacy pair-budget input (0 = a quarter of the scene); prefer --pair_budget")
    p.add_argument("--max_pairs_per_tile", type=int, default=4096, help="Per-tile depth-run capacity in the tile renderer; the front-to-back tail beyond it is dropped")
    p.add_argument("--auto_capacity", action="store_true", help="If the render sweep reports material truncation, double the relevant tile capacities and re-render (up to two escalations)")
    p.add_argument("--num_devices", type=int, default=0, help="Number of devices to shard the camera sweep/sampler over (0 = all local devices)")
    p.add_argument("--sh_colour_eval", action="store_true", help="Evaluate full view-dependent spherical harmonics per camera during the colour sweep (reference pipelines use degree-0 colours)")
    p.add_argument("--save_sweep", type=str, default=None, help="Save per-Gaussian sweep accumulators (colours/contributions/surface distances) to this .npz for later reuse")
    p.add_argument("--load_sweep", type=str, default=None, help="Load sweep accumulators from this .npz instead of re-rendering all cameras")
    p.add_argument("--pallas", type=str, default="auto", choices=["auto", "on", "off"], help="Use the hand-written Pallas TPU blend kernel ('auto' enables it on TPU backends)")
    p.add_argument("--shard_axis", type=str, default="cams", choices=["cams", "gauss", "both"], help="Multi-device sharding axis for the render sweep: 'cams' = camera data parallel, 'gauss' = depth-slab Gaussian parallel, 'both' = near-square 2-D (cams x gauss) mesh. Note: with 'gauss'/'both', a tile that saturates --max_pairs_per_tile blends up to devices x cap pairs, so results on cap-saturated scenes can vary slightly with --num_devices")
    p.add_argument("--dispatch_cameras", type=int, default=0, help="Cameras rendered per device dispatch during the colour sweep (0 = auto-size from the pair budget). Splitting the sweep into bounded dispatches is byte-identical to one monolithic dispatch and keeps each device program short")
    p.add_argument("--no_compact_pairs", action="store_true", help="Carry full-precision f32 colours through the tile renderer's per-pair tables instead of the default 8-bit-quantized compact rows (the output PLY stores 8-bit colours either way; compact halves the render sweep's per-pair memory traffic)")
    p.add_argument("--no_surface_compact", action="store_true", help="Compute each Gaussian's min surface distance over every pair in its tile runs instead of stopping at the tile's blend early exit (the reference kernel stops the surface pass there too; disabling matches the dense renderer's full-run semantics at the cost of extra render-sweep time)")
    p.add_argument("--profile_dir", type=str, default=None, help="Write a jax.profiler trace of the conversion to this directory (view with TensorBoard/XProf)")
    p.add_argument("--sampler_device", type=str, default="auto", choices=["auto", "device", "host"], help="Where point positions are sampled: 'device' samples on the accelerator and fetches the positions; 'host' re-derives them on the host CPU from the loaded scene (fetching only per-Gaussian quotas/colours — wins when the device->host link is slow); 'auto' probes the link bandwidth once and picks")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse CLI args with config-file support and reference validations."""
    parser = build_parser()
    ns, _ = parser.parse_known_args(argv)
    if ns.config is not None:
        file_argv = _read_config_file(ns.config, parser)
        argv_list = list(argv) if argv is not None else None
        if argv_list is None:
            import sys

            argv_list = sys.argv[1:]
        args = parser.parse_args(file_argv + argv_list)
    else:
        args = parser.parse_args(argv)
    validate_args(args)
    return args


def validate_args(args: argparse.Namespace) -> None:
    """Cross-flag validation, rule-for-rule with gauss_to_pc.py:650-708."""
    if args.min_opacity < 0 or args.min_opacity > 1:
        raise AttributeError("--min_opacity is a fraction: it must lie in [0, 1]")
    if args.mahalanobis_distance_std <= 0:
        raise AttributeError("--mahalanobis_distance_std must be a positive number of deviations")
    if args.num_points <= 0:
        raise AttributeError("--num_points must be a positive point count")

    for attr, label in (("bounding_box_min", "--bounding_box_min"), ("bounding_box_max", "--bounding_box_max")):
        val = getattr(args, attr)
        if val is not None:
            try:
                val = [float(x) for x in val]
            except ValueError:
                raise AttributeError(f"{label} takes numeric coordinates")
            if len(val) != 3:
                raise AttributeError(f"{label} needs exactly three values (x y z)")
            setattr(args, attr, val)

    if args.colour_quality.lower() not in COLOR_QUALITY_OPTIONS:
        raise AttributeError(
            f"--colour_quality '{args.colour_quality}' is not a known tier; "
            f"pick one of {list(COLOR_QUALITY_OPTIONS.keys())}"
        )
    if args.max_sh_degree < 0:
        raise AttributeError("--max_sh_degree cannot be negative")
    if args.camera_skip_rate < 0:
        raise AttributeError("--camera_skip_rate cannot be negative")
    if args.generate_mesh and args.no_calculate_normals:
        raise AttributeError("Meshing needs per-point normals; drop --no_calculate_normals")
    if args.generate_mesh and args.no_render_colours:
        raise AttributeError("Meshing needs rendered colours; drop --no_render_colours")
    if args.generate_mesh and args.transform_path is None:
        raise AttributeError("Meshing needs camera poses; supply --transform_path")
    if not args.no_render_colours and args.transform_path is None:
        raise AttributeError(
            "Rendering point colours needs camera poses: supply "
            "--transform_path, or pass --no_render_colours to skip the sweep"
        )
    if args.visibility_threshold < 0.0 or args.visibility_threshold > 1.0:
        raise AttributeError("--visibility_threshold is a contribution fraction: it must lie in [0, 1]")
    if args.surface_distance_std is not None and args.surface_distance_std <= 0.0:
        raise AttributeError("--surface_distance_std must be a positive number of deviations")
    if args.mask_path is not None and args.transform_path is None:
        raise AttributeError("Masks pair with camera poses; --mask_path needs --transform_path")
    if args.renderer_type not in RENDERER_ALIASES:
        raise AttributeError(
            f"Unknown --renderer_type '{args.renderer_type}' "
            "(use 'tile'/'cuda' or 'dense'/'python')"
        )
    # Reference restricts surface distance to its CUDA renderer
    # (gauss_to_pc.py:707-708); gs2pc's tile renderer is the equivalent.
    if RENDERER_ALIASES[args.renderer_type] != "tile" and args.surface_distance_std is not None:
        raise AttributeError("--surface_distance_std is only available with the tile renderer")


def settings_from_args(args: argparse.Namespace) -> GaussPointCloudSettings:
    """Build pipeline settings (parity: gauss_to_pc.py:716-737)."""
    return GaussPointCloudSettings(
        renderer_type=RENDERER_ALIASES[args.renderer_type],
        num_points=args.num_points,
        prioritise_visible_gaussians=not args.no_prioritise_visible_gaussians,
        mahalanobis_distance_std=args.mahalanobis_distance_std,
        camera_skip_rate=args.camera_skip_rate,
        render_colours=not args.no_render_colours,
        min_opacity=args.min_opacity,
        bounding_box_min=args.bounding_box_min,
        bounding_box_max=args.bounding_box_max,
        calculate_normals=not args.no_calculate_normals,
        cull_large_percentage=args.cull_gaussian_sizes,
        colour_resolution=COLOR_QUALITY_OPTIONS[args.colour_quality.lower()],
        max_sh_degree=args.max_sh_degree,
        exact_num_points=args.exact_num_points,
        visibility_threshold=args.visibility_threshold,
        surface_distance_std=args.surface_distance_std,
        generate_mesh=args.generate_mesh,
        quiet=args.quiet,
        remove_unrendered_gaussians=args.visibility_threshold > 0,
        seed=args.seed,
        sh_colour_eval=args.sh_colour_eval,
        save_sweep=args.save_sweep,
        load_sweep=args.load_sweep,
        shard_axis=args.shard_axis,
        auto_capacity=args.auto_capacity,
        sampler_device=args.sampler_device,
        render=RenderConfig(
            slots_per_gaussian=args.tile_slots,
            slots_small=args.tile_slots_small,
            big_cap=args.big_window_cap,
            pair_budget=args.pair_budget,
            max_pairs_per_tile=args.max_pairs_per_tile,
            use_pallas=args.pallas,
            dispatch_cams=args.dispatch_cameras,
            compact_pairs=not args.no_compact_pairs,
            surface_compact=not args.no_surface_compact,
        ),
    )
