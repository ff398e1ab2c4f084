"""gs2pc_torch.parallel.launch's pool of ranks on the CPU (gloo): a second
``run`` on the same devices hands its job to the ranks the first started;
each run's results equal the walk's, and each run's phases and launches
are filed once; a 2-D split's subgroups are made once a pool; a failure
tears the pool down and the next run starts a fresh one; another world
size or timeout replaces the pool; ``shutdown`` leaves no rank and no
group; an SPMD conversion run twice over one pool writes the walk's PLY
both times.

The runs share spawns: one module fixture makes every run of the pool's
life in order (five pools) and records what each left."""

import multiprocessing

import pytest
import torch

from gs2pc_torch import pipeline
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.ops import blend_kernel, rasterize
from gs2pc_torch.parallel import dryrun, launch
from gs2pc_torch.sweep import render_arrays
from gs2pc_torch.utils import log
from gs2pc_torch.utils.config import GaussPointCloudSettings
from tests.fixture_scene import write_capture

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPAWN_TIMEOUT_S = 120.0
WORLD = 4
SPLITS = ("both", "cams")
BRINGUP = ("spmd_spawn_import", "spmd_group_init")


@pytest.fixture(scope="module", autouse=True)
def _no_pool_outlives_the_file():
    yield
    launch.shutdown()


def count_launches(axis, root=None) -> None:
    """A rank function that counts rank r + 1 K1 launches and one K2 launch
    on rank r (the CPU launches no kernel), so that a report counted twice
    shows."""
    blend_kernel.blend_tiles.launches += axis.rank + 1
    rasterize.duplicate_with_keys.launches += 1


def _sweeps_job():
    g = dryrun.tiny_scene(device=CPU)
    cams = dryrun.tiny_cameras(3, device=CPU)
    cfg = rasterize.TileConfig(width_pad=cams.width_pad, height_pad=cams.height_pad)
    scene = render_arrays(g)
    calls = [(count_launches, ())] + [(dryrun.sweep_rank, (s, cfg)) for s in SPLITS]
    root = [None] + [(scene, cams, None)] * len(SPLITS)
    return scene, cams, cfg, calls, root


def _run(devices, calls, root, timeout=SPAWN_TIMEOUT_S) -> dict:
    """One run, with the state it left: the ranks started, the phases and
    launches filed, the pool's 2-D subgroups."""
    starts = launch.RANK_STARTS
    launch.RANK_LAUNCHES.clear()
    log.reset_phases()
    out = launch.run(launch.in_turn, devices, calls, root=root, timeout=timeout)
    pool = launch._POOL
    return dict(out=out, started=launch.RANK_STARTS - starts,
                phases=dict(log.PHASE_SECONDS),
                launches={r: dict(c) for r, c in launch.RANK_LAUNCHES.items()},
                grid=pool.axis._grid, children=len(multiprocessing.active_children()))


@pytest.fixture(scope="module")
def life():
    """The pool's life: two runs of the sweeps on [cpu] * 4, a planted
    failure, a run after it, a run on [cpu] * 2, one there at another
    timeout, then shutdown."""
    launch.shutdown()
    scene, cams, cfg, calls, root = _sweeps_job()
    rec = {"first": _run([CPU] * WORLD, calls, root), "second": _run([CPU] * WORLD, calls, root)}
    with pytest.raises(dryrun.PlantedFailure) as info:
        launch.run(dryrun.fail_on_rank, [CPU] * WORLD, 2, timeout=SPAWN_TIMEOUT_S)
    rec["failure"] = dict(cause=info.value.__cause__, pool=launch._POOL,
                          children=multiprocessing.active_children(),
                          group=torch.distributed.is_initialized())
    one = [(count_launches, ())]
    rec["after_failure"] = _run([CPU] * WORLD, one, [None])
    rec["two"] = _run([CPU] * 2, one, [None])
    rec["two_again"] = _run([CPU] * 2, one, [None])
    rec["two_timeout"] = _run([CPU] * 2, one, [None], timeout=SPAWN_TIMEOUT_S + 1)
    launch.shutdown()
    rec["shutdown"] = dict(pool=launch._POOL, children=multiprocessing.active_children(),
                           group=torch.distributed.is_initialized())
    rec["walks"] = {s: dryrun.WALKS[s](scene, cams, cfg, [CPU] * WORLD) for s in SPLITS}
    return rec


def test_a_second_run_on_the_same_devices_starts_no_rank(life):
    assert life["first"]["started"] == WORLD - 1
    assert life["second"]["started"] == 0
    assert life["first"]["children"] == life["second"]["children"] == WORLD - 1


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("run", ["first", "second"])
def test_each_run_over_the_pool_equals_the_walk(life, run, split):
    """Bit for bit, in the pool's first run and in the run that reuses it."""
    acc = life[run]["out"][1 + SPLITS.index(split)][0]
    walk = life["walks"][split]
    for name in dryrun.ACCUMULATORS:
        assert torch.equal(getattr(acc, name), getattr(walk, name)), name


def test_each_run_files_its_own_phases_and_launches(life):
    """The bring-up phases in the pool's first run only; every rank's
    sweep phases and launch counts of the run alone, in both runs."""
    for run in ("first", "second"):
        phases, launches = life[run]["phases"], life[run]["launches"]
        assert set(launches) == set(range(1, WORLD))
        for r in range(1, WORLD):
            assert launches[r]["blend_tiles"] == r + 1
            assert launches[r]["duplicate_with_keys"] == 1
            assert f"rank{r}/scene_broadcast" in phases
            for name in BRINGUP:
                assert (f"rank{r}/{name}" in phases) == (run == "first"), (run, name)
        assert ("spmd_group_init" in phases) == (run == "first")
        assert "spmd_dispatch" in phases and "spmd_report" in phases


def test_a_2d_split_makes_its_subgroups_once_a_pool(life):
    first, second = life["first"]["grid"], life["second"]["grid"]
    assert first is not None and first is second


def test_a_failure_tears_the_pool_down_and_the_next_run_starts_afresh(life):
    failure = life["failure"]
    assert isinstance(failure["cause"], launch.RemoteTraceback)
    assert failure["pool"] is None and failure["children"] == []
    assert not failure["group"]
    after = life["after_failure"]
    assert after["started"] == WORLD - 1
    assert after["launches"] == {r: dict(_counts(r)) for r in range(1, WORLD)}


def _counts(rank: int) -> dict:
    want = {name: 0 for name in launch.kernel_launches()}
    want.update(blend_tiles=rank + 1, duplicate_with_keys=1)
    return want


def test_another_world_size_or_timeout_replaces_the_pool(life):
    assert life["two"]["started"] == 1 and life["two"]["children"] == 1
    assert life["two_again"]["started"] == 0
    assert life["two_timeout"]["started"] == 1 and life["two_timeout"]["children"] == 1


def test_shutdown_leaves_no_rank_and_no_group(life):
    done = life["shutdown"]
    assert done["pool"] is None and done["children"] == [] and not done["group"]


def test_a_conversion_twice_over_one_pool_writes_the_walks_ply(tmp_path):
    """pipeline.convert_3dgs_to_pc on [cpu] * 2 twice: the second starts no
    rank, and both write the PLY bytes of the walk, which samples on one
    device."""
    capture = write_capture(str(tmp_path), n_cams=3, width=64, height=48)[3]
    settings = GaussPointCloudSettings(num_points=20_000, colour_resolution=None, quiet=True,
                                       surface_distance_std=1.0)
    args = (capture["ply"], capture["transforms"], capture["masks"], settings)
    walk = pipeline._convert_walked(*args, device="cpu", num_devices=2)
    save_point_cloud_ply(walk.cloud, str(tmp_path / "walk.ply"))
    want = (tmp_path / "walk.ply").read_bytes()
    assert len(want) > 1000
    launch.shutdown()
    starts = []
    for i in range(2):
        before = launch.RANK_STARTS
        res = pipeline.convert_3dgs_to_pc(*args, device="cpu", num_devices=2)
        starts.append(launch.RANK_STARTS - before)
        assert res.sweep_diag == walk.sweep_diag
        save_point_cloud_ply(res.cloud, str(tmp_path / f"spmd{i}.ply"))
        assert (tmp_path / f"spmd{i}.ply").read_bytes() == want, i
    assert starts == [1, 0]
