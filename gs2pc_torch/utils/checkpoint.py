"""Checkpoint and resume of the sweep's per-Gaussian accumulators (the
port's copy of gs2pc.utils.checkpoint, pinned by
tests/test_torch_io_copies.py).

A sweep saved here (colours, max / total contributions, min surface
distances) lets later runs sample again without re-rendering every
camera.  The file is the JAX package's ``.npz``, version 2, so a sweep saved
by either package loads in the other.  Beside the Gaussian count it holds
a fingerprint of the scene's float32 xyz bytes, checked on load: a
different scene of the same size would otherwise silently take its
colours.  The truncation counters are not saved; a loaded sweep has none.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from gs2pc_torch.sweep import SweepAccumulators

_FORMAT_VERSION = 2


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def scene_fingerprint(xyz) -> str:
    """Stable content hash of the scene geometry (float32 xyz bytes)."""
    arr = np.ascontiguousarray(_host(xyz), dtype=np.float32)
    return hashlib.sha1(arr.tobytes()).hexdigest()


def save_accumulators(
    path: str,
    acc: SweepAccumulators,
    num_gaussians: int,
    scene_xyz=None,
) -> None:
    """Write ``acc`` to ``path`` (numpy appends ``.npz`` to a path without it)."""
    extra = {}
    if scene_xyz is not None:
        extra["scene_hash"] = scene_fingerprint(scene_xyz)
    np.savez_compressed(
        path,
        version=_FORMAT_VERSION,
        num_gaussians=num_gaussians,
        max_contribution=_host(acc.max_contribution),
        colours=_host(acc.colours),
        total_contribution=_host(acc.total_contribution),
        min_surface_distance=_host(acc.min_surface_distance),
        **extra,
    )


def load_accumulators(
    path: str, num_gaussians: int, scene_xyz=None, *, device
) -> SweepAccumulators:
    """The accumulators saved at ``path``, on ``device``, with
    ``n_dropped=None``; raises when they belong to another scene."""
    with np.load(path) as data:
        if int(data["version"]) not in (1, _FORMAT_VERSION):
            raise ValueError(f"Unsupported accumulator checkpoint version in {path}")
        if int(data["num_gaussians"]) != num_gaussians:
            raise ValueError(
                f"Checkpoint {path} was computed for {int(data['num_gaussians'])} "
                f"Gaussians but the scene has {num_gaussians}"
            )
        if scene_xyz is not None and "scene_hash" in data:
            want = scene_fingerprint(scene_xyz)
            got = str(data["scene_hash"])
            if got != want:
                raise ValueError(
                    f"Checkpoint {path} was computed for a different scene "
                    f"(geometry fingerprint {got[:12]}... != {want[:12]}...); "
                    "re-run the render sweep for this input"
                )
        return SweepAccumulators(
            max_contribution=torch.as_tensor(data["max_contribution"], device=device),
            colours=torch.as_tensor(data["colours"], device=device),
            total_contribution=torch.as_tensor(data["total_contribution"], device=device),
            min_surface_distance=torch.as_tensor(data["min_surface_distance"], device=device),
        )
