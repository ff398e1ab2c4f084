"""The port's bench (gs2pc_torch/bench.py) on the CPU: its record contract
run as ``python -m gs2pc_torch.bench``, its conversion and its quality
gate against the JAX bench's on the same inputs, the oracle's bands
against one whole dense render, and the gate's edge cases (partial
oracles, the coverage verdict, the oracle cache, the refusal without a
card)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from gs2pc.utils.config import GaussPointCloudSettings as JaxSettings
from gs2pc.utils.config import RenderConfig as JaxRenderConfig
from gs2pc_torch import bench
from gs2pc_torch.ops.dense_render import render_dense
from gs2pc_torch.tools.validate_psnr import capture_scene, scene_arrays
from gs2pc_torch.utils import capture
from gs2pc_torch.utils.config import GaussPointCloudSettings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GAUSS = 256
N_POINTS = 4000
WIDTH, HEIGHT = 64, 48
# The JAX gate sizes its bands as 65,536 // width rows and breaks on an
# image of fewer rows (its band would not fit the image), so the gate's
# parity runs at 256x256; the port caps the band at the image.
GATE_WIDTH = GATE_HEIGHT = 256
# The gate against JAX's: the tile-vs-oracle error is the compact tables'
# 8-bit colour quantisation on both sides, and JAX's log-step blend and the
# port's pair-by-pair twin part by ~1e-6 in the images and contributions
# (measured: 4.2e-5 dB of 83.37 dB, and 1.4e-5 in the relative error).
TOL_PSNR_DB = 1e-3
TOL_CONTRIB_RELERR = 5e-5
# Oracle bands of 8 rows at 64 pixels a row: 6 bands at 64x48.
SMALL_BAND_PIXELS = 8 * WIDTH
RECORD_FIELDS = ("metric", "value", "unit", "vs_baseline", "t_total_s", "t_sweep_s", "t_io_s",
                 "sampler", "writer", "steady")
ACC_FIELDS = ("acc_contrib_relerr", "acc_surf_underrun", "acc_surf_bad_finite_frac")


def ply_vertex_count(path) -> int:
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.decode("ascii").strip()
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise AssertionError(f"{path} has no vertex count")


@pytest.fixture(autouse=True)
def capture_scene_kind(monkeypatch):
    monkeypatch.delenv("GS2PC_BENCH_SCENE", raising=False)


def test_bench_record_contract(tmp_path):
    """``python -m gs2pc_torch.bench`` on the CPU with the gate and stage 4
    on: a record after every stage, the last with the JAX bench's pinned
    fields, the gate's verdict at full coverage, and the points written."""
    env = dict(os.environ, PYTHONPATH=REPO, GS2PC_BENCH_DEVICE="cpu",
               GS2PC_BENCH_GAUSSIANS=str(N_GAUSS), GS2PC_BENCH_POINTS=str(N_POINTS),
               GS2PC_BENCH_CAMERAS="2", GS2PC_BENCH_WIDTH=str(WIDTH),
               GS2PC_BENCH_HEIGHT=str(HEIGHT), GS2PC_BENCH_PSNR_GAUSS=str(N_GAUSS),
               GS2PC_BENCH_COMPARE="1", GS2PC_BENCH_PALLAS="1",
               GS2PC_CACHE_DIR=str(tmp_path / "cache"), GS2PC_BENCH_DIR=str(tmp_path / "bench"))
    out = subprocess.run([sys.executable, "-m", "gs2pc_torch.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "GS2PC_BENCH_PALLAS tunes the TPU build only" in out.stderr
    lines = out.stdout.splitlines()
    records = [json.loads(line) for line in lines if line.startswith("{")]
    assert len(records) >= 3 and lines[-1].startswith("{"), out.stdout
    rec = records[-1]
    for field in RECORD_FIELDS + ACC_FIELDS + ("psnr_gate_pass", "psnr_vs_oracle",
                                               "power_limit", "peak_device_bytes"):
        assert field in rec, field
    assert rec["steady"] is True and records[0]["steady"] is False
    assert rec["unit"] == "points/s" and rec["value"] > 0
    assert rec["psnr_gate_pass"] is True and rec["psnr_oracle_coverage"] == 1.0
    assert rec["acc_contrib_relerr"] <= bench.ACC_RELERR_GATE
    assert rec["acc_surf_underrun"] == 0.0 and rec["acc_surf_bad_finite_frac"] == 0.0
    assert rec["points"] == ply_vertex_count(tmp_path / "bench" / "cloud.ply")
    assert (rec["device"], rec["blend"], rec["sampler"], rec["writer"]) == (
        "cpu", "torch", "torch", "native_stream")
    assert rec["power_limit"] is None and rec["peak_device_bytes"] is None
    assert rec["blend_mfu_est"] is None and rec["t_probe_s"] == 0.0
    assert rec["torch_sweep_s"] > 0 and rec["t_gate_s"] > 0
    assert list(os.listdir(tmp_path / "cache")) == [
        os.path.basename(bench.oracle_cache_path(N_GAUSS, WIDTH, HEIGHT))]


def test_run_e2e_matches_jax_bench(tmp_path, monkeypatch):
    """The port's run_e2e and the JAX bench's (JAX on the CPU, the XLA
    blend) convert one capture: the same point count and sweep counters,
    with nothing truncated by JAX's static pair budget."""
    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
    arrays = capture.make_scene_arrays(N_GAUSS)
    transforms, intr = capture.make_poses(2, WIDTH, HEIGHT)
    ply, tj, masks = capture.write_capture(str(tmp_path), arrays, transforms, intr,
                                           with_masks=True)
    want = jax_bench.run_e2e(ply, tj, masks, JaxSettings(
        num_points=N_POINTS, surface_distance_std=1e6, colour_resolution=WIDTH, quiet=True,
        render=JaxRenderConfig(use_pallas="off")), str(tmp_path / "jax.ply"))
    got = bench.run_e2e(ply, tj, masks, GaussPointCloudSettings(
        num_points=N_POINTS, surface_distance_std=1e6, colour_resolution=WIDTH, quiet=True),
        str(tmp_path / "port.ply"), "cpu")
    assert got["n_points"] == want["n_points"] > 0
    assert got["diag"] == want["diag"]
    assert got["diag"][0] > 0 and got["diag"][1] == 0.0
    assert got["n_points"] == ply_vertex_count(tmp_path / "port.ply")
    assert (got["blend"], got["sampler"], got["t_probe"]) == ("torch", "torch", 0.0)


def test_gate_matches_jax_bench(tmp_path, monkeypatch):
    """The port's gate and the JAX bench's on the same scene and camera give
    the same verdict fields within the tolerances above."""
    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax"))
    want = jax_bench.psnr_vs_oracle(N_GAUSS, GATE_WIDTH, GATE_HEIGHT, use_pallas=False)
    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path / "port"))
    got = bench.psnr_vs_oracle(N_GAUSS, GATE_WIDTH, GATE_HEIGHT, "cpu")
    assert want["complete"] and got["complete"]
    assert got["psnr_coverage"] == want["psnr_coverage"] == 1.0
    if want["psnr"] == 99.0:
        assert got["psnr"] == 99.0
    else:
        assert abs(got["psnr"] - want["psnr"]) <= TOL_PSNR_DB, (got, want)
    assert abs(got["acc_contrib_relerr"] - want["acc_contrib_relerr"]) <= TOL_CONTRIB_RELERR
    assert got["acc_surf_underrun"] == want["acc_surf_underrun"]
    assert got["acc_surf_bad_finite_frac"] == want["acc_surf_bad_finite_frac"]


def _gate_inputs():
    scene = scene_arrays(capture_scene(N_GAUSS, bench.ORACLE_SEED, "cpu"))
    cameras, wp, hp = capture.make_cameras(1, WIDTH, HEIGHT, device="cpu")
    return scene, cameras.at(0), wp, hp


def test_banded_oracle_equals_one_render(monkeypatch):
    """The oracle folded band by band (contrib by max, surf_dist by min)
    equals one whole render_dense of the same camera, bit for bit."""
    monkeypatch.setattr(bench, "BAND_PIXELS", SMALL_BAND_PIXELS)
    scene, cam, wp, hp = _gate_inputs()
    rows, n_blk = bench.oracle_bands(wp, hp)
    assert (rows, n_blk) == (8, 6)
    state = (np.zeros((n_blk * rows, wp, 3), np.float32), np.zeros(N_GAUSS, np.float32),
             np.full(N_GAUSS, bench.FLOAT_MAX_BENCH, np.float32), 0)
    img, contrib, surf, n_done = bench.fold_bands(scene, cam, wp, hp, state)
    whole = render_dense(*scene, cam, wp, hp, chunk=256, pixel_chunk=rows * wp,
                         calc_surface_distance=True, rect_cull=True)
    assert n_done == n_blk
    np.testing.assert_array_equal(img[:hp], whole.image.numpy())
    np.testing.assert_array_equal(contrib, whole.contrib.numpy())
    np.testing.assert_array_equal(surf, whole.surf_dist.numpy())
    assert contrib.max() > 0 and (surf < bench.FLOAT_MAX_BENCH).any()


def _deadline(bands: int):
    """A time_left() stub with time for the tile render and ``bands`` bands."""
    calls = iter([1000.0] * (1 + bands))
    return lambda: next(calls, 0.0)


def test_partial_oracle_reports_coverage_without_verdict(tmp_path, monkeypatch):
    """A deadline after 3 of 6 bands: the covered rows' PSNR, coverage 0.5,
    no accumulators and no verdict (its rows pass), and the 3 bands cached."""
    monkeypatch.setattr(bench, "BAND_PIXELS", SMALL_BAND_PIXELS)
    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path))
    gate = bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu", time_left=_deadline(3))
    assert gate["complete"] is False and gate["psnr_coverage"] == 0.5
    assert gate["psnr"] >= bench.PSNR_GATE_DB and "acc_contrib_relerr" not in gate
    fields, ok = bench.gate_fields(gate)
    assert ok and "psnr_gate_pass" not in fields
    assert fields["psnr_oracle_coverage"] == 0.5 and fields["psnr_vs_oracle"] > 0
    with np.load(bench.oracle_cache_path(N_GAUSS, WIDTH, HEIGHT)) as z:
        assert int(z["n_done"]) == 3


def test_partial_oracle_below_gate_fails():
    """Covered rows below 40 dB fail the gate before the oracle is whole."""
    fields, ok = bench.gate_fields({"psnr": 31.0, "psnr_coverage": 0.5, "complete": False})
    assert not ok and fields["psnr_gate_pass"] is False
    assert fields["psnr_oracle_coverage"] == 0.5


def test_coverage_reads_one_only_with_the_whole_oracle(tmp_path, monkeypatch):
    """At 64x40 (48 padded rows, 6 bands of 8) five bands cover every image
    row, yet the oracle is not whole: coverage stays below 1.0 and there is
    no verdict; the sixth band brings 1.0 and the verdict."""
    monkeypatch.setattr(bench, "BAND_PIXELS", SMALL_BAND_PIXELS)
    monkeypatch.setenv("GS2PC_CACHE_DIR", "")
    height = 40
    gate = bench.psnr_vs_oracle(N_GAUSS, WIDTH, height, "cpu", time_left=_deadline(5))
    assert gate["complete"] is False and gate["psnr_coverage"] < 1.0
    fields, ok = bench.gate_fields(gate)
    assert ok and "psnr_gate_pass" not in fields and fields["psnr_oracle_coverage"] < 1.0
    whole = bench.psnr_vs_oracle(N_GAUSS, WIDTH, height, "cpu")
    assert whole["complete"] is True and whole["psnr_coverage"] == 1.0
    assert whole["psnr"] == gate["psnr"]
    assert bench.gate_fields(whole)[0]["psnr_gate_pass"] is True


def test_partial_cache_resumes_to_the_whole(tmp_path, monkeypatch):
    """A run cut after 3 bands caches them; the next run renders the rest
    and gives what one uncached run gives."""
    monkeypatch.setattr(bench, "BAND_PIXELS", SMALL_BAND_PIXELS)
    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path))
    path = bench.oracle_cache_path(N_GAUSS, WIDTH, HEIGHT)
    bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu", time_left=_deadline(3))
    resumed = bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu")
    with np.load(path) as z:
        assert int(z["n_done"]) == 6
    monkeypatch.setenv("GS2PC_CACHE_DIR", "")
    assert resumed == bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu")


@pytest.mark.parametrize("fault", ["missing_key", "other_key"])
def test_bad_cache_renders_again_from_zero(tmp_path, monkeypatch, capsys, fault):
    """A cache that lacks one array, or was rendered from another key, is
    rendered again from zero: none of its arrays is used (a whole oracle of
    junk contributions would otherwise stay folded in), with a warning, and
    the cache is written anew."""
    monkeypatch.setenv("GS2PC_CACHE_DIR", str(tmp_path))
    fresh = bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu")
    path = bench.oracle_cache_path(N_GAUSS, WIDTH, HEIGHT)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    n_blk = int(arrays["n_done"])
    arrays["contrib"] = np.full_like(arrays["contrib"], 10.0)
    arrays["n_done"] = np.array(n_blk - 1)
    if fault == "missing_key":
        del arrays["surf"]
    else:
        arrays["key"] = np.array("seed=2 gaussians=256 another source")
    np.savez(path, **arrays)
    capsys.readouterr()
    again = bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu")
    assert again == fresh
    assert "rendering it again" in capsys.readouterr().err
    with np.load(path) as z:
        assert str(z["key"]) == bench.oracle_key(N_GAUSS, WIDTH, HEIGHT)
        assert int(z["n_done"]) == n_blk and "surf" in z.files
        assert float(z["contrib"].max()) < 10.0


def test_empty_cache_dir_writes_no_cache(tmp_path, monkeypatch):
    """GS2PC_CACHE_DIR="" disables the cache: no path, and nothing written
    under the default directory either."""
    monkeypatch.setenv("GS2PC_CACHE_DIR", "")
    monkeypatch.setattr(bench, "BUILD_DIR", str(tmp_path / "build"))
    assert bench.oracle_cache_path(N_GAUSS, WIDTH, HEIGHT) is None
    gate = bench.psnr_vs_oracle(N_GAUSS, WIDTH, HEIGHT, "cpu")
    assert gate["complete"] and not (tmp_path / "build").exists()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.delenv("GS2PC_CACHE_DIR")
    assert bench.oracle_cache_path(N_GAUSS, WIDTH, HEIGHT).startswith(str(tmp_path / "build"))


@pytest.mark.parametrize("device", [None, "cuda:0"])
def test_refuses_without_a_card(tmp_path, monkeypatch, device):
    """With no CUDA device and no GS2PC_BENCH_DEVICE=cpu, the bench exits
    non-zero with a message before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if device is None:
        monkeypatch.delenv("GS2PC_BENCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("GS2PC_BENCH_DEVICE", device)
    monkeypatch.setenv("GS2PC_BENCH_DIR", str(tmp_path / "bench"))
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)
    assert not (tmp_path / "bench").exists()
