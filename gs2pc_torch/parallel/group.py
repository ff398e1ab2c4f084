"""One axis of ranks and its collectives (the counterpart of a
``jax.sharding.Mesh`` axis and the ``lax`` collectives over it).

Each rank is one OS process that owns one device (gs2pc_torch.parallel.
launch starts them).  An ``Axis`` holds the rank, the axis size, the rank's
device and a ``torch.distributed`` process group, and offers the
collectives the sharded sweeps combine with:

  all_gather(t)  -> (D, *t.shape) on the rank's device, in rank order
  gather_blocks  every rank's block of rows, concatenated on rank 0 (all_gather)
  psum(t)        all_gather, then ``.sum(0)``
  pmax / pmin    ``all_reduce`` MAX / MIN
  broadcast_*    rank 0's tensors or object to every rank

A float sum is an all_gather followed by the one-thread walk's own
reduction, ``torch.stack(...).sum(0)`` in rank order on the same device
type, so an SPMD sweep equals its walk bit for bit by construction: NCCL's
``all_reduce`` leaves its summation order unspecified.  Max and min give
the same bits in any order (no value the sweeps reduce is NaN or a
negative zero), so they take ``all_reduce``, which moves D times fewer
bytes.

The backend follows the devices: NCCL when every rank has a CUDA card of
its own; gloo when every rank runs on the CPU, or when every rank shares
one card (``[cuda:0] * N``: NCCL refuses two ranks on one GPU).  On gloo a
CUDA tensor is copied to the host for the collective and the result back
to the card (``_host`` / ``_home`` below); a CPU tensor given to an NCCL
axis goes to the rank's card.  Any other mix of devices is refused.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


def backend_for(devices: Sequence[torch.device]) -> str:
    """"nccl" for distinct CUDA cards, "gloo" for the CPU or one shared
    card; raises on any other mix."""
    devices = [torch.device(d) for d in devices]
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return "gloo"
    if types == {"cuda"}:
        if any(d.index is None for d in devices):
            raise ValueError(f"CUDA ranks need a card index each: {devices}")
        indices = [d.index for d in devices]
        if len(set(indices)) == len(indices):
            return "nccl"
        if len(set(indices)) == 1:
            return "gloo"
    raise ValueError(
        f"no process-group backend for the devices {devices}: every rank on its own CUDA "
        "card (NCCL), or every rank on the CPU or on one shared card (gloo)"
    )


class Axis:
    """Rank ``rank`` of ``size`` on ``device``, in the process group
    ``group`` (the default group when None) whose members are the global
    ranks ``ranks``."""

    def __init__(self, rank: int, size: int, device: torch.device, group=None,
                 ranks: Optional[Sequence[int]] = None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.group = group
        self.ranks = list(range(size)) if ranks is None else list(ranks)
        self.backend = dist.get_backend(group)
        # Where a collective's buffers live: the host for gloo (which stages
        # a CUDA tensor there and back), the rank's card for NCCL.
        self._wire = torch.device("cpu") if self.backend == "gloo" else self.device
        self._grid: Optional[tuple] = None

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it (the host for gloo)."""
        return t.to(self._wire).contiguous()

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: (size, *t.shape)."""
        src = self._host(t)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return self._home(torch.stack(parts))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks in rank order (the walk's ``stack().sum(0)``)."""
        return self.all_gather(t).sum(dim=0)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        buf = self._host(t).clone()
        dist.all_reduce(buf, op, group=self.group)
        return self._home(buf)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def gather_blocks(self, t: torch.Tensor, lengths: Sequence[int]) -> Optional[torch.Tensor]:
        """Rank r's ``t`` of ``lengths[r]`` rows, concatenated in rank order
        on rank 0 (None on the others).  The blocks cross padded to the
        longest, by all_gather: NCCL's point-to-point ``gather`` took
        0.6-0.8 s a conversion on four H100s against a few milliseconds for
        all_gather, whose rings the sweep has already built (PERF.md)."""
        width = max(lengths)
        if width == 0:
            return t if self.rank == 0 else None
        buf = torch.zeros((width, *t.shape[1:]), dtype=t.dtype, device=t.device)
        buf[:t.shape[0]] = t
        parts = self.all_gather(buf)
        if self.rank != 0:
            return None
        return torch.cat([p[:n] for p, n in zip(parts, lengths)])

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, group=self.group, group_src=0)
        return box[0]

    def broadcast_tensors(self, tensors: Optional[Sequence[Optional[torch.Tensor]]] = None
                          ) -> list:
        """Rank 0's list of tensors (None entries allowed) on every rank's
        device, with their shapes and dtypes; the other ranks pass nothing.
        Bool tensors cross as uint8."""
        meta = None
        if self.rank == 0:
            meta = [None if t is None else (tuple(t.shape), t.dtype) for t in tensors]
        meta = self.broadcast_object(meta)
        out = []
        for i, m in enumerate(meta):
            if m is None:
                out.append(None)
                continue
            shape, dtype = m
            wire = torch.uint8 if dtype == torch.bool else dtype
            if self.rank == 0:
                buf = self._host(tensors[i].to(wire))
            else:
                buf = torch.empty(shape, dtype=wire, device=self._wire)
            dist.broadcast(buf, group=self.group, group_src=0)
            out.append(tensors[i] if self.rank == 0 else self._home(buf).to(dtype))
        return out

    def grid_2d(self) -> tuple["Axis", Optional["Axis"]]:
        """The near-square (cams x gauss) split of this axis
        (gs2pc_torch.parallel.gauss_shard.grid_2d's): rows of G consecutive
        ranks form the slab axes; the row leaders (the ranks whose slab
        rank is 0) form the camera axis.  Returns (this rank's slab axis,
        the camera axis or None off the leaders).  Every rank creates every
        subgroup, in the same order, on its first call: ``dist.new_group``
        is collective, so the subgroups are made once for the life of this
        axis (a pool's, gs2pc_torch.parallel.launch) and later calls return
        them."""
        if self._grid is not None:
            return self._grid
        rows = next(c for c in range(math.isqrt(self.size), 0, -1) if self.size % c == 0)
        g = self.size // rows
        slab = cams = None
        for r in range(rows):
            members = [self.ranks[i] for i in range(r * g, (r + 1) * g)]
            group = dist.new_group(members)
            if self.rank // g == r:
                slab = Axis(self.rank % g, g, self.device, group, members)
        leaders = [self.ranks[r * g] for r in range(rows)]
        group = dist.new_group(leaders)
        if self.rank % g == 0:
            cams = Axis(self.rank // g, rows, self.device, group, leaders)
        self._grid = (slab, cams)
        return self._grid
