"""The benchmark's scene export: read back by the program's loader, and the
same bytes from the same seed."""

import hashlib

import numpy as np
import pytest
import torch

import gsbench_tiny  # noqa: F401  (puts the benchmark on the path)
from gsbench import scene

CONFIG = dict(gaussians=200, sh_degree=3, images=5, width=64, height=48, focal_scale=0.9)


def _write(tmp_path, seed):
    return scene.write_capture(str(tmp_path / str(seed)), CONFIG, seed, "cpu")


def _digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_export_has_the_inria_layout(tmp_path):
    files = _write(tmp_path, 7)
    names = scene.export_properties(3)
    assert len(names) == 62 and names[6:9] == ["f_dc_0", "f_dc_1", "f_dc_2"]
    assert names[9:54] == [f"f_rest_{i}" for i in range(45)]
    with open(files["scene"], "rb") as fh:
        head = fh.read(4096).split(b"end_header\n")[0].decode()
    assert "element vertex 200" in head
    assert [ln.split()[2] for ln in head.splitlines() if ln.startswith("property")] == names
    assert files["bytes"] == len(head) + len("end_header\n") + 200 * 248


def test_program_loader_reads_the_export_back(tmp_path):
    from gs2pc_torch.io.gaussians_io import load_ply_gaussians

    gen = torch.Generator().manual_seed(11)
    sc = scene.make_scene(200, gen, "cpu")
    rows = scene.export_rows(sc, 3, gen)
    path = str(tmp_path / "s.ply")
    scene.write_export(path, rows, 3)
    xyz, log_scales, rots, colours, opacities, shs = load_ply_gaussians(path, max_sh_degree=3)
    np.testing.assert_array_equal(xyz, sc["xyz"].numpy())
    np.testing.assert_array_equal(log_scales, sc["log_scales"].numpy())
    np.testing.assert_allclose(colours, sc["colours"].numpy(), atol=1e-6)
    np.testing.assert_allclose(opacities, sc["opacities"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(rots, axis=1), 1.0, atol=1e-6)
    assert (rots[:, 0] >= 0).all()
    q = sc["rots"].numpy()
    np.testing.assert_allclose(rots, np.where(q[:, :1] < 0, -q, q), atol=1e-6)
    assert shs.shape == (200, 3, 16)
    np.testing.assert_allclose(shs[:, :, 1:].std(), scene.F_REST_STD, rtol=0.1)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 3])
def test_one_seed_gives_the_same_bytes(tmp_path, seed):
    a, b = _write(tmp_path / "a", seed), _write(tmp_path / "b", seed)
    assert _digest(a["scene"]) == _digest(b["scene"])
    assert _digest(a["transforms"]) == _digest(b["transforms"])


def test_seeds_order_the_same_content(tmp_path):
    """Every seed gives the conversion the same Gaussians, in another order."""
    from gsbench import reference as ref

    a, b = _write(tmp_path, 1)["scene"], _write(tmp_path, 2)["scene"]
    assert _digest(a) != _digest(b)
    ra, rb = (ref.read_export(p, "cpu")["xyz"] for p in (a, b))
    assert not torch.equal(ra, rb)
    key = lambda x: x[torch.argsort(x[:, 0] * 1e6 + x[:, 1] * 1e3 + x[:, 2])]  # noqa: E731
    assert torch.equal(key(ra), key(rb))


def test_scene_statistics_follow_the_capture():
    gen = torch.Generator().manual_seed(3)
    sc = scene.make_scene(10000, gen, "cpu")
    op = sc["opacities"]
    assert op.min() >= 0.05 and op.max() <= 1.0
    far = torch.linalg.vector_norm(sc["xyz"], dim=1) > 20.0
    assert int(far.sum()) == 10000 - int(10000 * 0.42) - int(10000 * 0.34) - int(10000 * 0.239)
    torch.testing.assert_close(torch.linalg.vector_norm(sc["rots"], dim=1),
                               torch.ones(10000), atol=1e-6, rtol=0)
