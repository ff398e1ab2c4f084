"""Sweep checkpoints (--save_sweep / --load_sweep): gs2pc_torch.utils.
checkpoint against gs2pc.utils.checkpoint, the file saved by either
package loading in the other, the same refusals, and conversions that
resume a saved sweep without transforms."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc import pipeline as jax_pipeline
from gs2pc.parallel.sweep import SweepAccumulators as JaxAccumulators
from gs2pc.utils import checkpoint as jax_ckpt
from gs2pc.utils.config import GaussPointCloudSettings as JaxSettings
from gs2pc_torch import pipeline
from gs2pc_torch.io.ply import save_point_cloud_ply
from gs2pc_torch.sweep import SweepAccumulators
from gs2pc_torch.utils import checkpoint
from gs2pc_torch.utils.config import GaussPointCloudSettings
from tests.fixture_scene import write_capture

torch.set_num_threads(1)

FIELDS = ("max_contribution", "colours", "total_contribution", "min_surface_distance")


def _accumulators(n, seed):
    r = np.random.default_rng(seed)
    return dict(
        max_contribution=r.uniform(0, 1, n).astype(np.float32),
        colours=r.uniform(0, 1, (n, 3)).astype(np.float32),
        total_contribution=r.uniform(0, 3, n).astype(np.float32),
        min_surface_distance=np.where(r.uniform(size=n) < 0.2, np.float32(3.4e38),
                                      r.uniform(0, 1, n)).astype(np.float32),
    )


def _xyz(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def test_fingerprint_matches_jax():
    xyz = _xyz(100, 0)
    assert checkpoint.scene_fingerprint(torch.tensor(xyz)) == jax_ckpt.scene_fingerprint(xyz)
    assert checkpoint.scene_fingerprint(xyz.astype(np.float64)) == jax_ckpt.scene_fingerprint(xyz)


def test_jax_checkpoint_loads_in_port(tmp_path):
    n, xyz, vals = 200, _xyz(200, 1), _accumulators(200, 1)
    path = str(tmp_path / "jax_sweep.npz")
    jax_ckpt.save_accumulators(path, JaxAccumulators(**{k: jnp.asarray(v) for k, v in vals.items()}),
                               n, scene_xyz=jnp.asarray(xyz))
    acc = checkpoint.load_accumulators(path, n, scene_xyz=torch.tensor(xyz), device="cpu")
    assert acc.n_dropped is None
    for name in FIELDS:
        got = getattr(acc, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), vals[name])


def test_port_checkpoint_loads_in_jax(tmp_path):
    n, xyz, vals = 200, _xyz(200, 2), _accumulators(200, 2)
    acc = SweepAccumulators(**{k: torch.tensor(v) for k, v in vals.items()},
                            n_dropped=torch.zeros(4, dtype=torch.float64))
    stem = str(tmp_path / "port_sweep")
    checkpoint.save_accumulators(stem, acc, n, scene_xyz=torch.tensor(xyz))
    path = stem + ".npz"  # numpy's suffix, as the JAX package writes it
    assert os.path.exists(path) and not os.path.exists(stem)
    loaded = jax_ckpt.load_accumulators(path, n, scene_xyz=jnp.asarray(xyz))
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)), vals[name])


def _jax_saved(tmp_path, n, xyz, vals):
    path = str(tmp_path / "jax_ref.npz")
    jax_ckpt.save_accumulators(path, JaxAccumulators(**{k: jnp.asarray(v) for k, v in vals.items()}),
                               n, scene_xyz=jnp.asarray(xyz))
    return path


@pytest.mark.parametrize("case", ["size", "scene"])
def test_refusals_match_jax(tmp_path, case):
    n, xyz, vals = 50, _xyz(50, 3), _accumulators(50, 3)
    path = _jax_saved(tmp_path, n, xyz, vals)
    if case == "size":
        args = (path, n + 1)
        kw = {}
    else:
        args = (path, n)
        kw = {"scene_xyz": _xyz(50, 4)}
    with pytest.raises(ValueError) as want:
        jax_ckpt.load_accumulators(*args, **kw)
    with pytest.raises(ValueError) as got:
        checkpoint.load_accumulators(*args, **kw, device="cpu")
    assert str(got.value) == str(want.value)
    assert ("different scene" if case == "scene" else "was computed for 50") in str(got.value)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _, _, _, paths = write_capture(str(root), n_cams=3, width=64, height=48)
    return paths


SETTINGS = dict(num_points=8000, colour_resolution=None, quiet=True, surface_distance_std=1.0)


def test_conversion_resumes_its_saved_sweep(capture, tmp_path):
    """--save_sweep, then --load_sweep without transforms or masks: the
    loaded accumulators equal the saved ones and the second PLY equals the
    first byte for byte."""
    path = str(tmp_path / "sweep.npz")
    first = pipeline.convert_3dgs_to_pc(
        capture["ply"], capture["transforms"], capture["masks"],
        GaussPointCloudSettings(**SETTINGS, save_sweep=path), device="cpu")
    second = pipeline.convert_3dgs_to_pc(
        capture["ply"], None, None, GaussPointCloudSettings(**SETTINGS, load_sweep=path),
        device="cpu")
    assert first.sweep_diag is not None and second.sweep_diag is None
    save_point_cloud_ply(first.cloud, str(tmp_path / "a.ply"))
    save_point_cloud_ply(second.cloud, str(tmp_path / "b.ply"))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_jax_saved_sweep_resumes_in_port(capture, tmp_path):
    """A sweep the JAX pipeline saved gives the port the JAX conversion's
    quotas and colours."""
    path = str(tmp_path / "jax_sweep.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GS2PC_CACHE_DIR", str(tmp_path / "jax_cache"))
        jpc, _ = jax_pipeline.convert_3dgs_to_pc(
            capture["ply"], capture["transforms"], capture["masks"],
            JaxSettings(**SETTINGS, save_sweep=path), num_devices=1)
    res = pipeline.convert_3dgs_to_pc(capture["ply"], None, None,
                                      GaussPointCloudSettings(**SETTINGS, load_sweep=path),
                                      device="cpu")
    np.testing.assert_array_equal(res.cloud.counts, np.asarray(jpc._counts))
    np.testing.assert_array_equal(res.cloud.cols_u8, np.asarray(jpc._cols_u8))
