"""Device lists for the multi-device sweeps (counterpart of
gs2pc.parallel.mesh).

The JAX package shards over a ``jax.sharding.Mesh``; here a sharded sweep
takes an explicit list of ``torch.device``: one process per device in the
SPMD sweeps (gs2pc_torch.parallel.launch, with parallel/group.py's Axis in
place of a mesh axis), or the list walked from one thread in their twins.
A device may repeat: the list ``[cuda:0] * 4`` runs a four-way split on
one card, the way the JAX tests run on virtual CPU devices.

  * axis "cams":  the camera sweep is data-parallel over cameras
    (gs2pc_torch.sweep.render_sweep_spmd / render_sweep_sharded);
  * axis "gauss": each camera's Gaussians are split into depth slabs
    (gs2pc_torch.parallel.gauss_shard).
"""

from __future__ import annotations

import torch


def devices(num_devices: int) -> list[torch.device]:
    """``cuda:0 .. cuda:N-1`` for a resolved N >= 1 (pipeline.
    resolve_num_devices turns 0 into the card count).

    Raises when more cards are asked for than the machine has (the JAX
    package's ``make_mesh`` would take the first N silently)."""
    have = torch.cuda.device_count()
    if num_devices > have:
        raise ValueError(
            f"--num_devices {num_devices} asks for {num_devices} CUDA devices, but "
            f"this machine has {have}"
        )
    return [torch.device("cuda", i) for i in range(num_devices)]


def split_evenly(n: int, parts: int) -> list[tuple[int, int]]:
    """``parts`` contiguous [lo, hi) blocks of range(n) whose sizes differ by
    at most one, larger blocks first (some are empty when n < parts)."""
    base, extra = divmod(n, parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds
