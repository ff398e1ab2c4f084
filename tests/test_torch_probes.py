"""gs2pc_torch's probe twins (K3, K4) against the TPU probes' own kernels,
run through pl.pallas_call(..., interpret=True) on the CPU: every body of
tools/pallas_probe.py and every level of tools/pallas_probe2.make_kernel,
on the TPU tools' inputs and on seeded ones (the kernels against their
twins on a card: test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from gs2pc_torch.ops import probe_kernels as PK
from gs2pc_torch.tools import cuda_probe, cuda_probe2
from tools import pallas_probe, pallas_probe2

torch.set_num_threads(1)

# The ops that sum add in another order than XLA: a few ulps of a sum of up
# to 256 terms.  Roll, min and the log-step scan make the same float
# operations as the JAX kernel and must be equal.
RTOL_SUM = 1e-6

_K3_BODY = {
    "row": pallas_probe.k_row_bcast, "repeat": pallas_probe.k_repeat,
    "mul": pallas_probe.k_mul_bcast, "dot": pallas_probe.k_dot_bcast,
    "roll": pallas_probe.k_roll, "concat": pallas_probe.k_concat_lanes,
    "slice": pallas_probe.k_lane_slice1, "min": pallas_probe.k_min_scalar,
    "scan": pallas_probe.k_scan_fwd,
}


def _jax_op(op, x):
    out = pl.pallas_call(
        _K3_BODY[op], out_shape=jax.ShapeDtypeStruct((PK.TPX, PK.RS), jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out)


def _assert_rel(got, want, rtol):
    d = np.abs(got - want)
    rel = np.divide(d, np.abs(want), out=np.zeros_like(d), where=d > 0)
    assert np.isfinite(rel).all() and rel.max() <= rtol, rel.max()


@pytest.mark.parametrize("kind", ["ones", "uniform"])
@pytest.mark.parametrize("op", [key for _, key in PK.PROBE_OPS])
def test_probe_op_twin_matches_pallas(op, kind):
    x = cuda_probe.make_input(kind, "cpu", seed=11)
    want = _jax_op(op, x.numpy())
    got = PK.probe_op(op, x).numpy()
    if op in PK.EXACT_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        _assert_rel(got, want, RTOL_SUM)


def test_roll_moves_lanes_up():
    """jnp.roll's direction, as the interpret-mode probe computes it: lane j
    moves to lane j + 4."""
    x = np.arange(PK.TPX * PK.RS, dtype=np.float32).reshape(PK.TPX, PK.RS)
    want = _jax_op("roll", x)
    assert want[0, 4] == x[0, 0] and want[0, 0] == x[0, PK.RS - 4]
    np.testing.assert_array_equal(PK.probe_op("roll", torch.tensor(x)).numpy(), want)


def _jax_level(level, starts, counts, dims, table, mask):
    """tools/pallas_probe2.try_level's pallas_call with these inputs."""
    NTP, TPX, RS, L = PK.NTP, PK.TPX, PK.RS, table.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(NTP,),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((1, TPX, 1), lambda t, *_: (t, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((1, TPX, 3), lambda t, *_: (t, 0, 0)),
            pl.BlockSpec((1, TPX, 1), lambda t, *_: (t, 0, 0)),
            pl.BlockSpec((1, TPX, 1), lambda t, *_: (t, 0, 0)),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        scratch_shapes=[
            pltpu.VMEM((16, RS), jnp.float32),
            pltpu.VMEM((1, RS), jnp.float32),
            pltpu.VMEM((1, RS), jnp.int32),
            pltpu.SemaphoreType.DMA,
            pltpu.SemaphoreType.DMA,
        ],
    )
    out_shape = [
        jax.ShapeDtypeStruct((NTP, TPX, 3), jnp.float32),
        jax.ShapeDtypeStruct((NTP, TPX, 1), jnp.float32),
        jax.ShapeDtypeStruct((NTP, TPX, 1), jnp.float32),
        jax.ShapeDtypeStruct((1, L), jnp.float32),
        jax.ShapeDtypeStruct((1, L), jnp.int32),
    ]
    outs = pl.pallas_call(
        pallas_probe2.make_kernel(level), grid_spec=grid_spec, out_shape=out_shape,
        interpret=True,
    )(*(jnp.asarray(a.numpy()) for a in (starts, counts, dims, table, mask)))
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("kind", ["ones", "seeded"])
@pytest.mark.parametrize("level", PK.LEVELS)
def test_probe_blend_twin_matches_pallas(level, kind):
    inputs = cuda_probe2.make_inputs(kind, "cpu", seed=5)
    rgb, ed, einv, m, apix = _jax_level(level, *inputs)
    got = PK.probe_blend(level, *inputs)
    for name, want in (("rgb", rgb), ("ed", ed), ("einv", einv)):
        _assert_rel(getattr(got, name).numpy(), want, RTOL_SUM)
    if level >= 5:
        # Interpret mode leaves the columns no chunk reached NaN (m).
        written = ~np.isnan(m)
        np.testing.assert_array_equal(~np.isnan(got.m.numpy()), written)
        _assert_rel(got.m.numpy()[written], m[written], RTOL_SUM)
        np.testing.assert_array_equal(got.apix.numpy()[written], apix[written])
        assert (got.apix.numpy()[~written] == -1).all()
        assert (m[written] > 0).sum() > 100
    else:
        assert np.isnan(got.m.numpy()).all() and (got.apix.numpy() == -1).all()


def test_seeded_probe_fires_the_stop_and_the_exit():
    """The seeded K4 input reaches what the levels add: pixels stop, a fully
    masked tile and one beyond num_tiles never enter a chunk."""
    starts, counts, dims, table, mask = cuda_probe2.make_inputs("seeded", "cpu", seed=5)
    got = PK.probe_blend(6, starts, counts, dims, table, mask)
    L = table.shape[1]
    m = got.m.numpy().reshape(L)
    for tile in (5, PK.NTP - 1):
        lo = int(starts[tile])
        assert int(counts[tile]) > 0 and np.isnan(m[lo:lo + int(counts[tile])]).all()
    # Without the stop (level 4 adds nothing else to T) a stopped pixel keeps
    # blending, so its colour sum grows: some pixels stopped.
    no_stop = PK.probe_blend(2, starts, counts, dims, table, mask)
    assert (no_stop.rgb[..., 1] > got.rgb[..., 1] + 1e-3).sum() > 0


def _k4_scan_replay(rows):
    """probes.cu's lane_scan4 on (n, 128) rows: thread t holds lanes t + 32k
    (v[:, k, t]); for s < 32 lane j - s is thread (t - s) & 31 of segment k,
    or of segment k - 1 when t < s (1.0 below segment 0); s = 32 and 64 are
    the segment one and two below, in the thread, top segment first."""
    v = rows.reshape(-1, 4, 32).copy()
    t = np.arange(32)
    s = 1
    while s < 32:
        r = v[:, :, (t - s) & 31]
        below = np.concatenate([np.ones_like(r[:, :1]), r[:, :-1]], axis=1)
        v = v * np.where(t >= s, r, below)
        s *= 2
    v[:, 3] *= v[:, 2]
    v[:, 2] *= v[:, 1]
    v[:, 1] *= v[:, 0]
    v[:, 3] *= v[:, 1]
    v[:, 2] *= v[:, 0]
    return v.reshape(-1, PK.RS)


def _k4_sum_replay(rows):
    """probes.cu's lane_sum4: lanes t + 64 onto t and t + 96 onto t + 32, the
    two segments' sums, then the xor butterfly; every thread's result."""
    v = rows.reshape(-1, 4, 32)
    s = (v[:, 0] + v[:, 2]) + (v[:, 1] + v[:, 3])
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, np.arange(32) ^ off]
    return s


def _k3_scan_replay(rows):
    """probes.cu's row_scan on (n, 128) rows: thread l holds lanes 4l..4l + 3
    (a[e][:, l]); __shfl_up_sync by d reads thread l - d (its own value
    below d)."""
    a = [rows.reshape(-1, 32, 4)[:, :, e].copy() for e in range(4)]
    lane = np.arange(32)

    def up(x, d):
        return np.where(lane >= d, np.roll(x, d, axis=1), x)

    one = np.float32(1.0)
    u = np.where(lane == 0, one, up(a[3], 1))
    a = [a[0] * u, a[1] * a[0], a[2] * a[1], a[3] * a[2]]
    u2 = np.where(lane == 0, one, up(a[2], 1))
    u3 = np.where(lane == 0, one, up(a[3], 1))
    a = [a[0] * u2, a[1] * u3, a[2] * a[0], a[3] * a[1]]
    d = 1
    while d < 32:
        a = [np.where(lane >= d, x * up(x, d), x) for x in a]
        d *= 2
    return np.stack(a, axis=-1).reshape(-1, PK.RS)


def _k4_rows(kind):
    """(1 - a0, w at T = 1, log(1 - a0)) of every pixel of tile 0's first
    chunk, as the twin computes them at level 2 on the tool's input."""
    starts, counts, dims, table, mask = cuda_probe2.make_inputs(kind, "cpu", seed=5)
    lane = torch.arange(PK.RS)
    px = (torch.arange(PK.TPX) % 16).to(torch.float32)[:, None]
    dx = px - table[0, lane][None, :]
    power = -0.5 * dx * dx
    alpha = torch.clamp(table[5, lane][None, :] * torch.exp(power), max=0.99)
    ok = (power <= 0) & (alpha >= 1 / 255) & (lane < int(counts[0]))[None, :]
    a0 = torch.where(ok, alpha, 0.0)
    excl = torch.where(lane < 1, 1.0, torch.roll(PK._lane_scan(1.0 - a0), 1, dims=-1))
    return {"1 - a0": 1.0 - a0, "w": a0 * excl, "log(1 - a0)": torch.log(1.0 - a0)}


@pytest.mark.parametrize("kind", ["ones", "seeded"])
def test_k4_lane_mapping_replays_the_twin(kind):
    """K4's lanes across the warp make the twin's scan multiplications and
    sum pairs bit for bit on the tool's inputs."""
    rows = _k4_rows(kind)
    got = _k4_scan_replay(rows["1 - a0"].numpy())
    np.testing.assert_array_equal(got, PK._lane_scan(rows["1 - a0"]).numpy())
    for name in ("w", "log(1 - a0)"):
        every = _k4_sum_replay(rows[name].numpy())
        assert (every == every[:, :1]).all(), name
        np.testing.assert_array_equal(every[:, 0], PK._lane_sum(rows[name]).numpy())
    assert (rows["1 - a0"] < 1).sum() > 100  # the scan multiplies something


@pytest.mark.parametrize("kind", ["ones", "uniform", "signed"])
def test_k3_row_scan_mapping_replays_the_twin(kind):
    """K3's float4-per-thread scan makes k_scan_fwd's multiplications bit
    for bit."""
    if kind == "signed":
        x = np.random.default_rng(4).uniform(-1.5, 1.5, (PK.TPX, PK.RS)).astype(np.float32)
    else:
        x = cuda_probe.make_input(kind, "cpu", seed=11).numpy()
    np.testing.assert_array_equal(_k3_scan_replay(x), PK._lane_scan(torch.tensor(x)).numpy())
    np.testing.assert_array_equal(_k4_scan_replay(x), PK._lane_scan(torch.tensor(x)).numpy())


@pytest.mark.parametrize("tool,n_lines", [(cuda_probe, 9), (cuda_probe2, 7)])
def test_probe_tools_print_one_ok_line_per_case(tool, n_lines, capsys):
    res = tool.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(res) == n_lines and all(r["ok"] for r in res.values())
    prefix = "" if tool is cuda_probe else "level "
    assert lines == [f"{prefix}{case}: OK" for case in res]


def test_probe_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        PK.probe_op("nope", torch.zeros((PK.TPX, PK.RS)))
    with pytest.raises(ValueError):
        PK.probe_op("roll", torch.zeros((PK.TPX, PK.RS), dtype=torch.float64))
    starts, counts, dims, table, mask = cuda_probe2.make_inputs("ones", "cpu")
    with pytest.raises(ValueError):
        PK.probe_blend(7, starts, counts, dims, table, mask)
    with pytest.raises(ValueError):  # a run past the table's columns
        PK.probe_blend(0, starts + 4000, counts, dims, table, mask)
