"""gs2pc_torch end to end against the JAX pipeline on the fixture capture,
the port's independence from JAX and from the JAX package, and its refusal
to run without CUDA."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gs2pc import pipeline as jax_pipeline
from gs2pc.camera import build_camera_batch as jax_build_camera_batch
from gs2pc.io.colmap import load_transform_data as jax_load_transforms
from gs2pc.io.gaussians_io import load_gaussians as jax_load_gaussians
from gs2pc.io.masks import load_image_masks as jax_load_masks
from gs2pc.ops.rasterize import TileConfig as JaxTileConfig
from gs2pc.utils.config import GaussPointCloudSettings, RenderConfig
from gs2pc_torch import pipeline
from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.io.colmap import load_transform_data
from gs2pc_torch.io.gaussians_io import load_gaussians
from gs2pc_torch.io.masks import load_image_masks
from gs2pc_torch.io.ply import save_point_cloud_ply
from tests.fixture_scene import write_capture

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The fixture's central tiles blend runs of a few hundred pairs.  The JAX
# blend multiplies transmittance in log-depth scans, the port's twin
# sequentially, pair by pair, so T drifts apart by up to ~1e-5 relative by the
# end of a deep run (single-camera parity at shallow depth holds 1e-6
# absolute, tests/test_torch_blend.py).
RTOL_ACC = 3e-5
TOL_CONTRIB = 1e-6
TOL_COLOUR = 1e-5
TOL_SURF = 1e-5
# Sampled positions, the same draws (tests/test_torch_sampler.py's TOL_POS).
TOL_POINTS = 1e-5

SETTINGS = GaussPointCloudSettings(
    num_points=20_000,
    colour_resolution=None,
    quiet=True,
    surface_distance_std=1.0,
    # pair_budget only sizes the JAX side (no window truncation there).
    render=RenderConfig(pair_budget=1 << 16, max_pairs_per_tile=256, run_chunk=64),
)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=4, width=96, height=72)
    return paths


@pytest.fixture(scope="module")
def sweeps(capture):
    """Both packages' camera sweeps on the fixture (1036 Gaussians, 4 cameras)."""
    transforms, intr = jax_load_transforms(capture["transforms"])
    masks = jax_load_masks(capture["masks"])
    jg = jax_load_gaussians(capture["ply"], compact_colours=True).calculate_normals()
    jcams, wp, hp = jax_build_camera_batch(transforms, intr, masks=masks)
    rc = SETTINGS.render
    jcfg = JaxTileConfig(
        width_pad=wp, height_pad=hp, pair_budget=rc.pair_budget,
        run_cap=rc.max_pairs_per_tile, run_chunk=rc.run_chunk, compact=True,
        surface_compact=True,
    )
    jacc = jax_pipeline.run_render_sweep(jg, jcams, jcfg, SETTINGS, num_devices=1)

    t_transforms, t_intr = load_transform_data(capture["transforms"])
    tcams = build_camera_batch(
        t_transforms, t_intr, masks=load_image_masks(capture["masks"]), device="cpu"
    )
    tg = load_gaussians(capture["ply"], compact_colours=True, device="cpu").calculate_normals()
    tacc = pipeline.run_render_sweep(tg, tcams, SETTINGS)
    return jg, jacc, tg, tacc


def test_sweep_accumulators_match_jax(sweeps):
    jg, jacc, tg, tacc = sweeps
    np.testing.assert_array_equal(np.asarray(jg.colours), tg.colours.numpy())
    np.testing.assert_allclose(
        np.asarray(jacc.max_contribution), tacc.max_contribution.numpy(),
        rtol=RTOL_ACC, atol=TOL_CONTRIB,
    )
    np.testing.assert_allclose(
        np.asarray(jacc.total_contribution), tacc.total_contribution.numpy(),
        rtol=RTOL_ACC, atol=TOL_CONTRIB,
    )
    np.testing.assert_allclose(np.asarray(jacc.colours), tacc.colours.numpy(), atol=TOL_COLOUR)
    js, ts = np.asarray(jacc.min_surface_distance), tacc.min_surface_distance.numpy()
    np.testing.assert_array_equal(js < 1e30, ts < 1e30)
    np.testing.assert_allclose(np.minimum(js, 1e6), np.minimum(ts, 1e6), atol=TOL_SURF)
    np.testing.assert_array_equal(np.asarray(jacc.n_dropped), tacc.n_dropped.numpy())
    assert float(tacc.n_dropped[1]) == 0.0


def test_cull_chain_matches_jax(sweeps):
    jg, jacc, tg, tacc = sweeps
    keep = jg.keep_mask & jax_pipeline.surface_keep_mask(jacc.min_surface_distance, 1.0)
    keep = keep & (jacc.max_contribution > SETTINGS.visibility_threshold)
    got = pipeline.cull_chain(tg, tacc, SETTINGS).keep_mask.numpy()
    np.testing.assert_array_equal(np.asarray(keep), got)
    assert 0 < got.sum() < got.size


@pytest.fixture(scope="module")
def conversions(capture, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:  # no stale JAX budget-probe cache
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
        jpc, _ = jax_pipeline.convert_3dgs_to_pc(
            capture["ply"], capture["transforms"], capture["masks"], SETTINGS, num_devices=1
        )
    result = pipeline.convert_3dgs_to_pc(
        capture["ply"], capture["transforms"], capture["masks"], SETTINGS, device="cpu"
    )
    return jpc, result


def test_conversion_matches_jax(conversions, capture):
    jpc, result = conversions
    cloud = result.cloud
    # Same quotas and u8 colours per Gaussian, so the same point count.
    np.testing.assert_array_equal(np.asarray(jpc._counts), cloud.counts)
    np.testing.assert_array_equal(np.asarray(jpc._cols_u8), cloud.cols_u8)
    assert cloud.total == jpc.total == int(cloud.counts.sum())
    assert result.sweep_diag[:4] == list(jax_pipeline.LAST_SWEEP_DIAG)
    # The same seed draws JAX's numbers (gs2pc_torch.ops.prng): positions
    # within float32 erf / exp / log1p rounding of JAX's.
    np.testing.assert_allclose(cloud.points, np.asarray(jpc.points), rtol=0, atol=TOL_POINTS)
    # Each lies in its Gaussian's Mahalanobis ball of radius
    # mahalanobis_distance_std.
    g = load_gaussians(capture["ply"], device="cpu").validate_covariances()
    gid = torch.tensor(cloud.gauss_ids())
    R = g.rotation_matrices()[gid].double()
    d = torch.tensor(cloud.points).double() - g.xyz[gid].double()
    z = torch.einsum("nji,nj->ni", R, d) / torch.exp(g.log_scales[gid]).double()
    assert float(z.norm(dim=1).max()) <= SETTINGS.mahalanobis_distance_std + 1e-4
    np.testing.assert_allclose(np.asarray(jpc.normals), cloud.normals, atol=1e-6)


def test_ply_matches_jax_writer_layout(conversions, tmp_path):
    from gs2pc.io.ply import read_xyz_ply

    _, result = conversions
    out = str(tmp_path / "cloud.ply")
    save_point_cloud_ply(result.cloud, out, chunk_size=4096)
    pts, cols, nrm = read_xyz_ply(out)
    np.testing.assert_array_equal(pts, result.cloud.points)
    np.testing.assert_array_equal(cols, result.cloud.cols_u8[result.cloud.gauss_ids()])
    np.testing.assert_array_equal(nrm, result.cloud.normals)


def test_port_never_imports_jax(capture, tmp_path):
    """CPU conversions, one with the depth-slab sweep on two devices (two
    processes joined by parallel/launch.py and parallel/group.py) and the
    PLY write, one with --sh_colour_eval --generate_mesh --save_sweep then
    the cleaning and the mesh, and the port's bench's run_e2e, load no JAX,
    no bench harness of the JAX package and no module of gs2pc/."""
    script = textwrap.dedent(f"""
        import sys
        import gs2pc_torch.cli
        import gs2pc_torch.parallel.group
        import gs2pc_torch.parallel.launch
        from gs2pc_torch.io.ply import save_point_cloud_ply
        from gs2pc_torch.meshing import clean_point_cloud, generate_mesh
        from gs2pc_torch.pipeline import convert_3dgs_to_pc
        from gs2pc_torch.utils.config import GaussPointCloudSettings
        s = GaussPointCloudSettings(num_points=5000, colour_resolution=None, quiet=True,
                                    surface_distance_std=1.0, shard_axis="gauss")
        res = convert_3dgs_to_pc({capture['ply']!r}, {capture['transforms']!r},
                                 {capture['masks']!r}, s, device="cpu", num_devices=2)
        save_point_cloud_ply(res.cloud, {str(tmp_path / 'out.ply')!r})
        assert res.cloud.total > 0
        s = GaussPointCloudSettings(num_points=5000, colour_resolution=None, quiet=True,
                                    sh_colour_eval=True, generate_mesh=True,
                                    save_sweep={str(tmp_path / 'sweep.npz')!r})
        res = convert_3dgs_to_pc({capture['ply']!r}, {capture['transforms']!r},
                                 {capture['masks']!r}, s, device="cpu")
        save_point_cloud_ply(clean_point_cloud(res.cloud, device="cpu"),
                             {str(tmp_path / 'clean.ply')!r})
        surf = res.surface_cloud
        mesh = generate_mesh(surf.points, surf.cols_u8[surf.gauss_ids()], surf.normals,
                             {str(tmp_path / 'mesh.ply')!r}, depth=5, laplacian_iters=2,
                             device="cpu")
        assert len(mesh.faces) > 0, mesh
        from gs2pc_torch import bench
        run = bench.run_e2e({capture['ply']!r}, {capture['transforms']!r}, {capture['masks']!r},
                            GaussPointCloudSettings(num_points=5000, colour_resolution=None,
                                                    quiet=True, surface_distance_std=1e6),
                            {str(tmp_path / 'bench.ply')!r}, "cpu")
        assert run["n_points"] > 0 and run["blend"] == "torch", run
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "bench", "gs2pc"))
        assert not bad, bad
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_tools_never_import_jax(capture, tmp_path):
    """Every module of gs2pc_torch.tools imports, and cuda_probe /
    cuda_probe2, render_preview, convert_format, pixel_forensics and the
    multi-device dry run run on the CPU, without JAX, the bench harness,
    gs2pc or the JAX package's tools/."""
    out = str(tmp_path)
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import numpy as np
        import gs2pc_torch.tools as T
        for m in pkgutil.iter_modules(T.__path__):
            importlib.import_module(f"gs2pc_torch.tools.{{m.name}}")
        from gs2pc_torch.parallel.dryrun import dryrun_multichip
        from gs2pc_torch.tools import (convert_format, cuda_probe, cuda_probe2,
                                       pixel_forensics, render_preview)
        assert all(r["ok"] for r in cuda_probe.main(["--device", "cpu"]).values())
        assert all(r["ok"] for r in cuda_probe2.main(["--device", "cpu", "--input", "seeded"]).values())
        assert len(render_preview.main(["--input_path", {capture['ply']!r}, "--transform_path",
                                        {capture['transforms']!r}, "--out_dir", {out!r},
                                        "--max_images", "1", "--colour_quality", "tiny",
                                        "--device", "cpu"])) == 1
        assert convert_format.main([{capture['ply']!r}, {out + '/s.splat'!r}]) > 0
        img = np.full((64, 64, 3), 0.5, np.float32)
        np.savez({out + '/img.npz'!r}, image=img)
        recs = pixel_forensics.main(["--tile_npz", {out + '/img.npz'!r}, "--oracle_npz",
                                     {out + '/img.npz'!r}, "--gaussians", "100", "--width", "64",
                                     "--height", "64", "--worst", "1", "--device", "cpu"])
        assert len(recs) == 1
        dryrun_multichip(2, "cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "bench", "gs2pc", "tools"))
        assert not bad, bad
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "NO_JAX_OK" in proc.stdout
    assert sum(": OK" in ln and not ln.startswith("dryrun") for ln in lines) == 16
    assert sum(ln.startswith("dryrun_multichip(2)") and ": OK;" in ln for ln in lines) == 3


def test_cli_refuses_to_run_without_cuda(capture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "gs2pc_torch", "--input_path", capture["ply"],
         "--transform_path", capture["transforms"], "--output_path",
         str(tmp_path / "out.ply"), "--num_points", "1000"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "out.ply").exists()


@pytest.mark.parametrize("flag", [
    ["--generate_mesh"], ["--clean_pointcloud"], ["--save_sweep", "s.npz"],
    ["--load_sweep", "s.npz"], ["--sh_colour_eval"], ["--auto_capacity"],
])
def test_cli_refuses_unported_flags(flag):
    """The six flags once refused as not ported now pass the flag checks;
    without CUDA the CLI still exits non-zero before reading anything."""
    from gs2pc_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--input_path", "x.ply", "--transform_path", "t.json", *flag])


def test_auto_capacity_matches_jax(capture, tmp_path):
    """--auto_capacity with a run cap of 32 on the fixture: the run cap
    doubles while live cap drops stay material, as many times as in the
    JAX pipeline (whose pair budget keeps every window, so only its run
    cap grows too), and the final sweep's accumulators and counters are
    JAX's."""
    settings = SETTINGS._replace(auto_capacity=True,
                                 render=SETTINGS.render._replace(max_pairs_per_tile=32))
    sweeps = {"jax": [], "port": []}

    def spy(module, key):
        real = module.run_render_sweep

        def wrapped(*a, **kw):
            sweeps[key].append(real(*a, **kw))
            return sweeps[key][-1]
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
        mp.setattr(jax_pipeline, "run_render_sweep", spy(jax_pipeline, "jax"))
        mp.setattr(pipeline, "run_render_sweep", spy(pipeline, "port"))
        jax_pipeline.convert_3dgs_to_pc(capture["ply"], capture["transforms"],
                                        capture["masks"], settings, num_devices=1)
        res = pipeline.convert_3dgs_to_pc(capture["ply"], capture["transforms"],
                                          capture["masks"], settings, device="cpu")
    assert len(sweeps["port"]) == len(sweeps["jax"]) >= 2
    jacc, tacc = sweeps["jax"][-1], sweeps["port"][-1]
    assert float(jacc.n_dropped[1]) == 0.0
    assert res.sweep_diag[:4] == list(jax_pipeline.LAST_SWEEP_DIAG)
    np.testing.assert_array_equal(np.asarray(jacc.n_dropped), tacc.n_dropped.numpy())
    np.testing.assert_allclose(np.asarray(jacc.max_contribution), tacc.max_contribution.numpy(),
                               rtol=RTOL_ACC, atol=TOL_CONTRIB)
    np.testing.assert_allclose(np.asarray(jacc.colours), tacc.colours.numpy(), atol=TOL_COLOUR)
    first = pipeline.truncation_material(
        [float(x) for x in sweeps["port"][0].n_dropped])
    assert first == (False, True)


@pytest.mark.parametrize("flag", [
    ["--renderer_type", "dense"], ["--renderer_type", "python"], ["--profile_dir", "p"],
])
def test_cli_takes_dense_and_profile_dir_then_needs_cuda(flag):
    """The dense oracle and --profile_dir pass the flag checks; without CUDA
    the CLI still exits non-zero before reading anything."""
    from gs2pc_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--input_path", "x.ply", "--transform_path", "t.json", *flag])


def test_profile_dir_trace_names_the_phases(capture, tmp_path):
    """cli.profiling around a CPU conversion writes a Chrome trace whose
    named ranges are the pipeline's phases."""
    import json

    from gs2pc_torch import cli
    from gs2pc_torch.utils.config import GaussPointCloudSettings as Settings

    out = tmp_path / "prof"
    settings = Settings(num_points=3000, colour_resolution=None, quiet=True)
    with cli.profiling(str(out)):
        pipeline.convert_3dgs_to_pc(capture["ply"], capture["transforms"], capture["masks"],
                                    settings, device="cpu")
    assert os.listdir(out) == [cli.TRACE_NAME]
    with open(out / cli.TRACE_NAME) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    for phase in ("load_gaussians", "render_sweep", "cull_chain", "point_sampling"):
        assert phase in names


def test_cli_takes_sharded_sweeps_then_needs_cuda(capsys):
    """--num_devices / --shard_axis pass the flag checks; without CUDA the
    CLI still exits non-zero before reading anything."""
    from gs2pc_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for axis in ("cams", "gauss", "both"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--input_path", "x.ply", "--transform_path", "t.json",
                      "--num_devices", "4", "--shard_axis", axis])


def test_cli_warns_on_tpu_only_flags(capsys):
    from gs2pc_torch import cli
    from gs2pc_torch.utils.config import parse_args

    cli.check_flags(parse_args(["--input_path", "x.ply", "--transform_path", "t.json",
                                "--pallas", "on", "--pair_budget", "100"]))
    err = capsys.readouterr().out
    assert "--pallas tunes the TPU build only" in err
    assert "--pair_budget tunes the TPU build only" in err
