"""The readers of the SPMD ranks' phases and spans (the four-card cell's
per-layer metrics) on hand-made runs, and a tiny run of the four-card mix
on four CPU ranks through the harness."""

import pytest

import gsbench_tiny as tiny
from gsbench.harness import RunRecord, metric_reader

RANKS = ("rank_start_s", "scene_broadcast_s", "rank_sweep_max_s", "sweep_gather_s",
         "pool_handoff_s")


def _record(phases: list) -> RunRecord:
    return RunRecord(setup_s=5.0, window_s=1.0,
                     conversions=[dict(wall_s=0.5, phases=p, sweep_diag=None) for p in phases],
                     peak_bytes=10**9, n_gaussians=1000, renders=4)


# A conversion that started its ranks (the pool's first, or every one at a
# program that starts them anew), then one over ranks already up.
STARTED = {"scene_broadcast": 0.7, "sweep": 0.5, "gather": 0.3, "spmd_group_init": 9.0,
           "rank1/spmd_spawn_import": 6.0, "rank1/spmd_cuda_context": 1.0,
           "rank1/spmd_library_load": 0.5, "rank1/spmd_group_init": 1.0, "rank1/sweep": 0.8,
           "rank2/spmd_spawn_import": 7.0, "rank2/spmd_cuda_context": 1.5,
           "rank2/spmd_library_load": 0.5, "rank2/spmd_group_init": 0.5, "rank2/sweep": 0.4}
KEPT = {"scene_broadcast": 0.05, "sweep": 0.2, "gather": 0.01, "spmd_dispatch": 0.001,
        "spmd_report": 0.003, "rank1/sweep": 0.25, "rank2/sweep": 0.15,
        "rank1/scene_broadcast": 0.06}


def test_rank_readers_take_a_conversions_mean():
    run = _record([STARTED, KEPT])
    assert metric_reader("rank_start_s")(run) == pytest.approx((7.0 + 1.5 + 0.5 + 0.5) / 2)
    assert metric_reader("scene_broadcast_s")(run) == pytest.approx((0.7 + 0.05) / 2)
    assert metric_reader("rank_sweep_max_s")(run) == pytest.approx((0.8 + 0.25) / 2)
    assert metric_reader("sweep_gather_s")(run) == pytest.approx((0.3 + 0.01) / 2)
    assert metric_reader("pool_handoff_s")(run) == pytest.approx((0.001 + 0.003) / 2)


def test_rank_start_reads_zero_where_the_ranks_were_up():
    assert metric_reader("rank_start_s")(_record([KEPT, KEPT])) == 0.0


def test_pool_handoff_reads_nothing_without_its_spans():
    """The parent's runs: ranks started anew for every conversion."""
    assert metric_reader("pool_handoff_s")(_record([STARTED, STARTED])) is None


def test_rank_readers_read_nothing_on_one_card():
    run = _record([{"load_gaussians": 0.2, "render_sweep": 0.7, "ply_write": 0.3}])
    for name in RANKS:
        assert metric_reader(name)(run) is None, name


def test_the_four_card_mix_runs_on_four_cpu_ranks():
    """The mix's --num_devices 4 wins over the harness's --num_devices 1:
    every conversion of a tiny window sweeps on four CPU ranks, the ranks
    started once (in the warm conversion), and the run is correct."""
    from gs2pc_torch.parallel import launch

    starts = launch.RANK_STARTS
    try:
        with tiny.on_cpu():
            res = tiny.run("full-colour-4card", trace=True)
    finally:
        launch.shutdown()
    assert launch.RANK_STARTS - starts == 3
    assert res["correct"] and res["failed"] == 0
    values = {k: v["value"] for k, v in res["metrics"].items()}
    assert values["rank_start_s"] == 0.0
    for name in RANKS[1:]:
        assert values[name] > 0.0, name
    assert "rank3/sweep" in res["phases_s"]
