"""gs2pc_torch's SPMD sweeps (one process per device, gloo on the CPU): the
camera, depth-slab and 2-D sweeps at world sizes 2 and 4 on
tests/test_torch_shard.py's scenes, bit-equal to their one-thread walks and
held to the JAX package's shard_map sweeps on its virtual CPU mesh; SPMD
conversions, their samplings split over the ranks, whose PLY bytes equal
the walk's (which samples on one device) at world sizes 2, 3 and 4; a rank
that raises, and a rank 0 that raises before the sampling.

World sizes 2 and 4 are one spawn each that runs every case in turn
(launch.in_turn); world size 3 and the two failures are a spawn each."""

import functools
import multiprocessing
import time

import numpy as np
import pytest
import torch

from gs2pc.parallel import gauss_shard as jax_gs
from gs2pc.parallel.mesh import make_mesh
from gs2pc.parallel.sweep import render_sweep_sharded as jax_render_sweep_sharded
from gs2pc_torch import pipeline
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.parallel import dryrun, group, launch
from gs2pc_torch.utils.config import GaussPointCloudSettings
from tests.fixture_scene import write_capture
from tests.test_torch_shard import _assert_close, _cfgs, _gauss_setup, _scene

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_pool_outlives_the_file():
    """launch.run keeps its ranks for the next run: close them with the file."""
    yield
    launch.shutdown()


CPU = torch.device("cpu")
SPLITS = ("cams", "gauss", "both")
SCENES = ("plain", "masked", "saturating")
ACCUMULATORS = dryrun.ACCUMULATORS
# Every spawn's own bound (the suite must not hang on a lost rank).
SPAWN_TIMEOUT_S = 120.0
# The (scene, split) sweep held to JAX at each world size, the 2-D one,
# which runs both axes' collectives: a JAX sweep costs ~8 s of compiles
# here.  The others are held to JAX through their walks, which every SPMD
# sweep equals bit for bit: tests/test_torch_shard.py holds the walks at
# world size 4 (the plain scene on every split, the masked and saturating
# ones on the depth-slab split), and the camera walk equals one device.
JAX_CASES = {2: ("saturating", "both"), 4: ("masked", "both")}


def _masked_setup():
    """test_gauss_sharded_masks_match_jax's scene: 200 Gaussians, two 48x48
    cameras with random masks (so 4 ranks leave two camera blocks empty)."""
    rng = np.random.default_rng(0)
    masks = {f"c{i}": (rng.uniform(size=(48, 48)) > 0.4).astype(np.uint8) for i in range(2)}
    return _scene(200, 41, 1.0, -3.2, -1.6, 2, 48, 48, 55.0, 2.1, masks=masks)


@functools.lru_cache(maxsize=1)
def _cases():
    """{scene: (JAX arrays, JAX cameras, JAX cfg, port scene, port cameras,
    port cfg)}; "saturating" is the plain scene at a run cap it saturates
    (test_per_slab_run_cap_divergence_matches_jax's)."""
    plain, masked = _gauss_setup(), _masked_setup()
    out = {}
    for name, (arrays, jcams, tscene, tcams, wp, hp), kw in (
            ("plain", plain, {}), ("masked", masked, {"n": 200}),
            ("saturating", plain, {"run_cap": 64, "run_chunk": 64})):
        jcfg, cfg = _cfgs(wp, hp, **kw)
        out[name] = (arrays, jcams, jcfg, tscene, tcams, cfg)
    return out


def _conversion_settings(world: int) -> GaussPointCloudSettings:
    """World 2: the depth-slab split with SH colours per camera (the SH
    broadcast); world 4: the 2-D split with --auto_capacity at a run cap
    the fixture saturates (rank 0 decides each re-sweep), masks and the
    mesh's surface cloud in both."""
    if world == 2:
        return GaussPointCloudSettings(num_points=20_000, colour_resolution=None, quiet=True,
                                       surface_distance_std=1.0, shard_axis="gauss",
                                       sh_colour_eval=True)
    s = GaussPointCloudSettings(num_points=20_000, colour_resolution=None, quiet=True,
                                surface_distance_std=1.0, generate_mesh=True, shard_axis="both",
                                auto_capacity=True)
    return s._replace(render=s.render._replace(max_pairs_per_tile=16, run_chunk=16))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd_capture")
    return write_capture(str(root), n_cams=3, width=64, height=48)[3]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def spmd(request, capture):
    """One spawn of ``world`` ranks on the CPU: every scene x split as an
    SPMD sweep, then an SPMD conversion; rank 0's results."""
    world = request.param
    cases = _cases()
    calls, root = [], []
    for name in SCENES:
        _, _, _, tscene, tcams, cfg = cases[name]
        for split in SPLITS:
            calls.append((dryrun.sweep_rank, (split, cfg)))
            root.append((tscene, tcams, None))
    settings = _conversion_settings(world)
    calls.append((pipeline.convert_rank,
                  (capture["ply"], capture["transforms"], capture["masks"], settings)))
    root.append(None)
    launch.RANK_LAUNCHES.clear()
    t0 = time.perf_counter()
    out = launch.run(launch.in_turn, [CPU] * world, calls, root=root, timeout=SPAWN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    assert wall < SPAWN_TIMEOUT_S
    spawned = {r: dict(c) for r, c in launch.RANK_LAUNCHES.items()}
    sweeps = {}
    for i, name in enumerate(SCENES):
        for j, split in enumerate(SPLITS):
            acc, _, launches = out[i * len(SPLITS) + j]
            assert len(launches) == world  # every rank reports (no kernel on the CPU)
            sweeps[name, split] = acc
    return dict(world=world, cases=cases, sweeps=sweeps, conversion=out[-1],
                settings=settings, spawned=spawned)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("scene", SCENES)
def test_spmd_sweep_equals_the_walk(spmd, scene, split):
    """Bit for bit: the SPMD sweep reduces with the walk's expressions."""
    _, _, _, tscene, tcams, cfg = spmd["cases"][scene]
    walk = dryrun.WALKS[split](tscene, tcams, cfg, [CPU] * spmd["world"])
    acc = spmd["sweeps"][scene, split]
    for name in ACCUMULATORS:
        assert torch.equal(getattr(acc, name), getattr(walk, name)), name


def _jax_sweep(split, arrays, jcams, jcfg, world):
    if split == "cams":
        return jax_render_sweep_sharded(arrays, jcams, jcfg, make_mesh(world))
    if split == "gauss":
        return jax_gs.render_sweep_gauss_sharded(arrays, jcams, jcfg,
                                                 jax_gs.make_gauss_mesh(world))
    return jax_gs.render_sweep_2d(arrays, jcams, jcfg, jax_gs.make_2d_mesh(world))


def test_spmd_sweep_matches_jax(spmd):
    """Held to the JAX package's shard_map sweep on as many virtual CPU
    devices, at tests/test_torch_shard.py's bounds; the counters equal."""
    scene, split = JAX_CASES[spmd["world"]]
    arrays, jcams, jcfg, *_ = spmd["cases"][scene]
    jacc = _jax_sweep(split, arrays, jcams, jcfg, spmd["world"])
    acc = spmd["sweeps"][scene, split]
    _assert_close(jacc, acc)
    np.testing.assert_array_equal(acc.n_dropped.numpy(), np.asarray(jacc.n_dropped))


def test_spmd_conversion_writes_the_walks_ply(spmd, capture, tmp_path):
    """The conversion with its sweep and samplings over the ranks (rank 0
    parses, the scene and SH broadcast, rank 0 decides every
    --auto_capacity re-sweep, every rank samples a block of the slots)
    writes the PLY bytes the walk writes, and the same counters."""
    settings = spmd["settings"]
    walk = pipeline._convert_walked(capture["ply"], capture["transforms"], capture["masks"],
                                    settings, device="cpu", num_devices=spmd["world"])
    res = spmd["conversion"]
    assert res.sweep_diag == walk.sweep_diag
    clouds = [(res.cloud, walk.cloud)]
    if settings.generate_mesh:
        clouds.append((res.surface_cloud, walk.surface_cloud))
        assert res.sweep_diag[3] > 0  # the run cap did saturate
    for i, (a, b) in enumerate(clouds):
        _assert_same_ply(a, b, str(tmp_path / f"spmd{i}.ply"), str(tmp_path / f"walk{i}.ply"))


def test_spawned_ranks_report_their_launches(spmd):
    """Every spawned rank reports its K1, K2, key sort, K5, K6 and record
    decode launches to rank 0 (launch.RANK_LAUNCHES): none here, where the
    wrappers run their twins on the CPU tensors."""
    assert set(launch.kernel_launches()) == {"blend_tiles", "duplicate_with_keys",
                                             "order_pairs", "sample_points",
                                             "project_and_pack", "preprocess",
                                             "ply_decode"}
    want = {name: 0 for name in launch.kernel_launches()}
    assert spmd["spawned"] == {r: want for r in range(1, spmd["world"])}


def test_sweep_devices_put_the_callers_card_first(monkeypatch):
    """Rank 0 of an SPMD conversion runs it on the caller's ``device``: that
    card leads the sweep's devices, then the lowest-numbered others."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert pipeline.sweep_devices(cuda[0], 4) == cuda
    assert pipeline.sweep_devices(cuda[2], 3) == [cuda[2], cuda[0], cuda[1]]
    assert pipeline.sweep_devices(torch.device("cuda"), 2) == [cuda[3], cuda[0]]
    assert pipeline.sweep_devices(cuda[1], 1) == [cuda[1]]
    with pytest.raises(ValueError):
        pipeline.sweep_devices(cuda[1], 5)


def _assert_same_ply(a, b, path_a: str, path_b: str) -> None:
    save_point_cloud_ply(a, path_a)
    save_point_cloud_ply(b, path_b)
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert len(want) > 1000 and got == want


def test_spmd_conversion_at_world_three_equals_one_device(capture, tmp_path):
    """Three ranks split both samplings (the cloud and --generate_mesh's
    surface cloud, --exact_num_points so the cut at max_points too) into
    blocks one slot apart in size; rank 0's gathered
    clouds write the PLY bytes of the walk, which samples on one device."""
    settings = GaussPointCloudSettings(num_points=20_000, colour_resolution=None, quiet=True,
                                       surface_distance_std=1.0, generate_mesh=True,
                                       exact_num_points=True)
    res = launch.run(pipeline.convert_rank, [CPU] * 3, capture["ply"], capture["transforms"],
                     capture["masks"], settings, timeout=SPAWN_TIMEOUT_S)
    walk = pipeline._convert_walked(capture["ply"], capture["transforms"], capture["masks"],
                                    settings, device="cpu", num_devices=3)
    assert res.surface_quota == walk.surface_quota and res.surface_quota[1] > 0
    assert res.cloud.total == 20_000 and res.surface_cloud.total % 3 != 0
    _assert_same_ply(res.cloud, walk.cloud, str(tmp_path / "a.ply"), str(tmp_path / "b.ply"))
    _assert_same_ply(res.surface_cloud, walk.surface_cloud, str(tmp_path / "c.ply"),
                     str(tmp_path / "d.ply"))


def test_rank_zero_failing_before_the_sampling_fails_the_run(capture):
    """Rank 0 raises between the sweep and the sampling (every Gaussian
    culled) while rank 1 waits for its sampling: the run raises rank 0's
    error well within the group's timeout, and no rank is left running."""
    settings = GaussPointCloudSettings(num_points=5000, colour_resolution=None, quiet=True,
                                       min_opacity=2.0)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="every Gaussian was culled"):
        launch.run(pipeline.convert_rank, [CPU] * 2, capture["ply"], capture["transforms"],
                   capture["masks"], settings, timeout=SPAWN_TIMEOUT_S)
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT_S / 2
    assert multiprocessing.active_children() == []
    assert not torch.distributed.is_initialized()


def test_a_failed_rank_fails_the_run():
    """Rank 2 of 3 raises while ranks 0 and 1 wait on it in a collective:
    the caller raises rank 2's error, with its traceback as the cause, well
    within the group's timeout, and no rank is left running."""
    t0 = time.perf_counter()
    with pytest.raises(dryrun.PlantedFailure, match="rank 2") as info:
        launch.run(dryrun.fail_on_rank, [CPU] * 3, 2, timeout=SPAWN_TIMEOUT_S)
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT_S / 2
    assert isinstance(info.value.__cause__, launch.RemoteTraceback)
    assert "fail_on_rank" in str(info.value.__cause__)
    assert multiprocessing.active_children() == []
    assert not torch.distributed.is_initialized()


def test_backend_follows_the_devices():
    """NCCL only where every rank has a card of its own; gloo on the CPU and
    on one shared card; any other mix raises (no spawn)."""
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert group.backend_for([CPU] * 3) == "gloo"
    assert group.backend_for(cuda) == "nccl"
    assert group.backend_for([cuda[0]] * 4) == "gloo"
    for devices in ([CPU, cuda[0]], [cuda[0], cuda[0], cuda[1]], [torch.device("cuda")] * 2):
        with pytest.raises(ValueError):
            group.backend_for(devices)
