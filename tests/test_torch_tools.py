"""gs2pc_torch's quality and diagnostics tools on CPU tensors (the kernels'
twins) at a tiny size: validate_psnr, ablate_psnr with its atomic oracle
cache, diff_map, and bench_breakdown's refusal to time without a card;
and the CLI's --profile_dir trace."""

import json
import os

import numpy as np
import pytest
import torch

from gs2pc_torch.tools import ablate_psnr, bench_breakdown, diff_map, validate_psnr

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--gaussians", "300", "--width", "64", "--height", "64"]


def test_validate_psnr_on_cpu():
    res = validate_psnr.main(["--device", "cpu", "--gaussians", "500", "--cams", "1",
                              "--width", "64", "--height", "64"])
    (cam,) = res["cameras"]
    assert res["worst_psnr_db"] >= validate_psnr.VISUALLY_LOSSLESS_DB
    assert cam["max_contrib_delta"] < 1e-4 and cam["dense_s"] > 0


def test_validate_psnr_production_config_with_masks():
    """Compact tables, the surface pass and masks against the rect-culled
    oracle: still visually lossless."""
    res = validate_psnr.main(["--device", "cpu", "--gaussians", "800", "--cams", "2",
                              "--width", "64", "--height", "48", "--masks", "--production",
                              "--rect_cull"])
    assert len(res["cameras"]) == 2
    assert res["worst_psnr_db"] >= validate_psnr.VISUALLY_LOSSLESS_DB


def test_ablate_one_config_caches_the_oracle(tmp_path, capsys):
    cache = str(tmp_path / "oracle.npz")
    recs = ablate_psnr.main(SMALL + ["--configs", "prod", "--oracle_npz", cache])
    (rec,) = recs
    assert rec["config"] == "prod" and rec["psnr_db"] >= validate_psnr.VISUALLY_LOSSLESS_DB
    assert rec["pairs_blended"] > 0 and rec["t_render_s"] > 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert json.loads(line[0])["config"] == "prod"
    # The cache is complete and nothing else is left in its directory.
    assert os.listdir(tmp_path) == ["oracle.npz"]
    with np.load(cache) as z:
        assert z["image"].shape == (64, 64, 3)
    # A second run reads the cache instead of rendering.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ablate_psnr, "banded_oracle", None)
        again = ablate_psnr.main(SMALL + ["--configs", "twin", "--oracle_npz", cache])
    assert again[0]["config"] == "twin"


def test_ablate_twin_config_matches_prod(tmp_path):
    """On CPU tensors K1 already runs its twin: the twin row equals prod."""
    cache = str(tmp_path / "oracle.npz")
    prod, twin = ablate_psnr.main(SMALL + ["--configs", "prod,twin", "--oracle_npz", cache])
    assert prod["psnr_db"] == twin["psnr_db"]
    with pytest.raises(ValueError, match="unknown configs"):
        ablate_psnr.main(SMALL + ["--configs", "xla", "--oracle_npz", cache])


def test_ablate_renders_a_stale_oracle_cache_again(tmp_path, capsys):
    """A cache of the right shape from another scene or oracle source (here
    a blank image without a key, then one under another key) is rendered
    again, not read."""
    cache = str(tmp_path / "oracle.npz")
    key = ablate_psnr.oracle_key(300, 64, 64)
    for stale_key in (None, key.replace("seed=2", "seed=3")):
        extra = {} if stale_key is None else {"key": np.array(stale_key)}
        ablate_psnr.save_npz_atomic(cache, image=np.zeros((64, 64, 3), np.float32), **extra)
        (rec,) = ablate_psnr.main(SMALL + ["--configs", "prod", "--oracle_npz", cache])
        assert rec["psnr_db"] >= validate_psnr.VISUALLY_LOSSLESS_DB
        assert "rendering it again" in capsys.readouterr().err
        with np.load(cache) as z:
            assert str(z["key"]) == key and z["image"].any()


def test_save_npz_atomic_leaves_the_old_file_on_failure(tmp_path):
    path = str(tmp_path / "c.npz")
    ablate_psnr.save_npz_atomic(path, image=np.ones(3))

    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("cut")

    with pytest.raises(RuntimeError):
        ablate_psnr.save_npz_atomic(path, image=Boom())
    assert os.listdir(tmp_path) == ["c.npz"]
    with np.load(path) as z:
        assert (z["image"] == 1).all()


def test_diff_map_on_cpu(tmp_path):
    stats = diff_map.main(SMALL + ["--oracle_npz", str(tmp_path / "o.npz"),
                                   "--save_npz", str(tmp_path / "tile.npz")])
    assert 0.0 <= stats["max_err"] < 0.1 and stats["num_tiles"] == 16
    assert len(stats["worst_tiles"]) == 16
    assert os.path.exists(tmp_path / "tile.npz")


def test_bench_breakdown_needs_a_card():
    with pytest.raises(SystemExit, match="CUDA device"):
        bench_breakdown.main(["--device", "cpu"])
