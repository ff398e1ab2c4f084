"""The plain reference against the program at a tiny size on the CPU
twins: it agrees with a sound conversion, calls every planted fault wrong,
and calls the TF32 control wrong."""

import dataclasses

import pytest
import torch
from unittest import mock

import gsbench_tiny as tiny
from gsbench import reference as ref

MIXES = ["readme-mip", "full-colour"]


def _failed(result) -> list:
    return [k for k, c in result["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("mix", MIXES)
def test_reference_agrees_with_the_program(mix):
    with tiny.on_cpu():
        r = tiny.run(mix)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["judged"]["colour"] >= 40 and r["judged"]["count"] >= 100
    for name in ("layout", "count_off", "colour_off", "repeat_diff"):
        assert r["checks"][name]["value"] == 0.0, name


def _cull_patch(fn):
    from gs2pc_torch import pipeline

    orig = pipeline.cull_chain

    def patched(g, acc, settings):
        return fn(orig(g, acc, settings))

    return mock.patch.object(pipeline, "cull_chain", patched)


def _colour_one_level(g):
    return dataclasses.replace(g, colours=torch.clamp(g.colours + 1.0, max=255.0))


def _drop_one(g):
    keep = g.keep_mask.clone()
    keep[int(keep.nonzero()[0])] = False
    return dataclasses.replace(g, keep_mask=keep)


def _point_outside():
    from gs2pc_torch import pipeline

    orig = pipeline.sample_points

    def patched(*a, **k):
        res = orig(*a, **k)
        pts = res.points.clone()
        pts[1] += 1.0
        return res._replace(points=pts)

    return mock.patch.object(pipeline, "sample_points", patched)


def _sweep_patch(cams_of):
    from gs2pc_torch import pipeline

    orig = pipeline.sweep_with_capacity

    def patched(g, cameras, settings, devices):
        return orig(g, cams_of(cameras, g.device), settings, devices)

    return mock.patch.object(pipeline, "sweep_with_capacity", patched)


def _unchanged_state():
    """The sweep returns its accumulators as they start."""
    from gs2pc_torch import pipeline, sweep

    def patched(g, cameras, settings, devices):
        return sweep.init_accumulators(g.num_gaussians, device=g.device), None

    return mock.patch.object(pipeline, "sweep_with_capacity", patched)


def _half_budget():
    """The quotas apportion half the point budget."""
    from gs2pc_torch import pipeline

    orig = pipeline.distribute_points

    def patched(sizes, num_points, **k):
        return orig(sizes, num_points // 2, **k)

    return mock.patch.object(pipeline, "distribute_points", patched)


FAULTS = {
    "colours one level off": lambda: _cull_patch(_colour_one_level),
    "a dropped Gaussian": lambda: _cull_patch(_drop_one),
    "a point outside its Gaussian": _point_outside,
    "half the cameras left out": lambda: _sweep_patch(
        lambda c, d: c.sub(0, c.num_cameras // 2, d)),
    "the sweep's state returned unchanged": _unchanged_state,
    "half the point budget": _half_budget,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault):
    with tiny.on_cpu(), FAULTS[fault]():
        r = tiny.run("full-colour")
    assert not r["correct"]
    assert r["failed"] or _failed(r), r["checks"]


def test_tf32_control_is_not_correct():
    """The control at a size a test holds: the reference at TF32 in the
    program's place, its cloud judged by the cell's comparison, fails it."""
    from control import control_run

    config = dict(tiny.CONFIG, gaussians=20000, width=320, height=213)
    check = dict(sample=dict(uniform=512, in_cloud=512), limits=tiny.LIMITS)
    traffic = tiny.traffic("full-colour")
    flags = traffic["flags"]
    flags[flags.index("--num_points") + 1] = "200000"
    out = control_run(config, traffic, check, 9, "cpu")
    assert not out["ok"]
    assert {"colour_off", "count_off", "mahal_max", "normal_gap"} <= set(_failed(out)), out
    assert out["checks"]["layout"]["value"] == 0.0, out
    assert "budget_off" not in out["checks"]
    assert out["kept"] >= 512 and out["judged"]["colour"] >= 400, out


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265])
    y = ref.round_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]
    assert abs(float(y[4]) + 3.14159265) < 2**-9 * 4
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()


def test_rows_are_attributed_by_their_centres():
    centres = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [4.0, 5.0, 6.0], [4.1, 5.0, 6.0],
                        [4.2, 5.0, 6.0]])
    gid, rows, gids = ref.attribute_rows(pts, centres)
    assert gid.tolist() == [0, 0, 2, 2, 2]
    assert rows.tolist() == [0, 2] and gids.tolist() == [0, 2]
