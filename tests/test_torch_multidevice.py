"""The port's multi-device sweeps on repeated CPU devices: the camera,
depth-slab and 2-D sweeps against one device, a block that fails, the
conversion's PLYs whatever the number of devices, and the multi-device dry
run.  The JAX comparison of the sweeps lives in tests/test_torch_shard.py."""

import pytest
import torch

from gs2pc_torch import pipeline, sweep
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.ops import rasterize as R
from gs2pc_torch.parallel import dryrun, gauss_shard, launch
from gs2pc_torch.sweep import render_arrays, render_sweep, render_sweep_sharded
from gs2pc_torch.utils.config import GaussPointCloudSettings
from tests.fixture_scene import write_capture

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_pool_outlives_the_file():
    """launch.run keeps its ranks for the next run: close them with the file."""
    yield
    launch.shutdown()


CPU = torch.device("cpu")
SWEEPS = {"cams": render_sweep_sharded, "gauss": gauss_shard.render_sweep_gauss_sharded,
          "both": gauss_shard.render_sweep_2d}
ACCUMULATORS = ("max_contribution", "colours", "total_contribution", "min_surface_distance",
                "n_dropped")


def _setup(n_cams=3):
    g = dryrun.tiny_scene(device=CPU)
    cams = dryrun.tiny_cameras(n_cams, device=CPU)
    cfg = R.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad, compact=True,
                       surface_compact=True)
    return render_arrays(g), cams, cfg


@pytest.mark.parametrize("n_dev", [2, 3])
@pytest.mark.parametrize("axis", ["cams", "gauss", "both"])
def test_sharded_sweep_equals_one_device(axis, n_dev):
    """Each split on [cpu] * n against the one-device sweep: the camera
    split exactly but for the total's summation order, the slab sweeps
    within the dry run's bounds; a second run gives the same bits."""
    scene, cams, cfg = _setup()
    devices = [CPU] * n_dev
    acc = SWEEPS[axis](scene, cams, cfg, devices)
    again = SWEEPS[axis](scene, cams, cfg, devices)
    for name in ACCUMULATORS:
        assert torch.equal(getattr(acc, name), getattr(again, name)), name
    one = render_sweep(scene, cams, cfg)
    d = dryrun.accumulator_diffs(acc, one)
    if axis == "cams":
        assert all(d[k] == 0.0 for k in ACCUMULATORS if k != "total_contribution"), d
        assert d["total_contribution"] <= dryrun.TOL_TOTAL
    else:
        assert dryrun._slab_ok(d, acc, one), d


class _Planted(RuntimeError):
    pass


@pytest.mark.parametrize("axis", ["cams", "gauss", "both"])
def test_worker_exception_reaches_the_caller(axis, monkeypatch):
    """The second render raises: the sweep raises it and returns nothing."""
    scene, cams, cfg = _setup()
    real = R.render_tile_camera
    calls = [0]

    def planted(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise _Planted("planted")
        return real(*a, **kw)

    monkeypatch.setattr(sweep, "render_tile_camera", planted)
    monkeypatch.setattr(gauss_shard, "render_tile_camera", planted)
    with pytest.raises(_Planted, match="planted"):
        SWEEPS[axis](scene, cams, cfg, [CPU] * 4)
    assert calls[0] == 2


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=3, width=64, height=48)
    return paths, root


def test_num_devices_leaves_the_ply_bytes_equal(capture, tmp_path):
    """The whole conversion with the camera split on [cpu] * 1, * 2 and * 3
    (the sampler on the first device in each): the point cloud and
    --generate_mesh's surface cloud are equal byte for byte."""
    paths, _ = capture
    base = GaussPointCloudSettings(num_points=20_000, colour_resolution=None, quiet=True,
                                   surface_distance_std=1.0, generate_mesh=True)
    plys = []
    for n in (1, 2, 3):
        res = pipeline.convert_3dgs_to_pc(paths["ply"], paths["transforms"], paths["masks"],
                                          base, device="cpu", num_devices=n)
        for cloud, tag in ((res.cloud, "pc"), (res.surface_cloud, "surface")):
            out = str(tmp_path / f"{tag}{n}.ply")
            save_point_cloud_ply(cloud, out)
            plys.append((tag, open(out, "rb").read()))
    for tag in ("pc", "surface"):
        first, *rest = [b for t, b in plys if t == tag]
        assert len(first) > 1000 and all(b == first for b in rest), tag


@pytest.mark.parametrize("n_dev", [3, 4])
def test_dryrun_multichip_passes_on_cpu(n_dev, capsys):
    verdicts = dryrun.dryrun_multichip(n_dev, "cpu")
    axes = {"cams", "points", "gauss"} | ({"2-D"} if n_dev >= 4 else set())
    assert set(verdicts) == axes
    assert verdicts["points"]["valid"] > dryrun.MIN_VALID
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if f"dryrun_multichip({n_dev})" in ln]
    assert len(lines) == len(axes) and all(": OK;" in ln for ln in lines)


@pytest.mark.parametrize("module, axis", [(sweep, "cams"), (gauss_shard, "2-D")])
def test_dryrun_multichip_raises_on_a_merge_fault(module, axis, monkeypatch, capsys):
    """A merge that drops every block after the first: the axis that merges
    with it differs (and with the camera split, the sampler fed by it)."""
    monkeypatch.setattr(module, "merge_accumulators", lambda a, b: a)
    with pytest.raises(ValueError, match=f"{axis}.* differ"):
        dryrun.dryrun_multichip(4, "cpu")
    assert f"{axis}: DIFFERS" in capsys.readouterr().out
