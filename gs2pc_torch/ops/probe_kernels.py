"""K3 and K4: the diagnostics probes (CUDA kernels in
gs2pc_torch/csrc/probes.cu) and their plain PyTorch twins.

K3 ``probe_op`` replaces tools/pallas_probe.py::run (its nine kernel
bodies): one op on a (256, 128) float32 block.  K4 ``probe_blend``
replaces tools/pallas_probe2.py::try_level (make_kernel(level)): a
stripped-down blend of 16 tiles of a 64x64 image at levels 0-6.  Each
answers, on this card, the question its TPU probe answers: does this
feature build, launch and compute the right value?  A wrapper launches its
kernel for CUDA tensors and runs the twin only for CPU tensors; there is no
fallback between the two.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from gs2pc_torch.ops.blend import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE

RS = 128  # lanes: the probes' chunk of pairs
TPX = TILE * TILE  # pixels of a tile
NTP = 16  # tiles of the K4 image
L_AL = NTP * RS * 2  # table columns of the TPU probe's inputs
GRID_W = 4  # tiles per row of the K4 image
WIDTH_PAD = 64  # its padded row length in pixels
LEVELS = tuple(range(7))

# K3's ops in tools/pallas_probe.py's order: (the case name it prints, key).
PROBE_OPS = (
    ("row(1,RS) sublane bcast", "row"),
    ("repeat (TPX,1)->(TPX,RS)", "repeat"),
    ("mul implicit lane bcast", "mul"),
    ("dot_general K=1 outer", "dot"),
    ("pltpu.roll lanes", "roll"),
    ("concat width-1 lanes", "concat"),
    ("lane slice width 1", "slice"),
    ("reduce to scalar + add", "min"),
    ("hillis-steele lane scan", "scan"),
)
_OP_CODE = {"row": 0, "repeat": 1, "mul": 2, "dot": 3, "roll": 4, "concat": 5, "slice": 6,
            "min": 7, "scan": 8}
# Ops whose kernel and twin make the same float operations in the same
# order; the others sum in another order.
EXACT_OPS = ("roll", "min", "scan")


class ProbeBlendResult(NamedTuple):
    rgb: torch.Tensor  # (NTP, 256, 3)
    ed: torch.Tensor  # (NTP, 256, 1)
    einv: torch.Tensor  # (NTP, 256, 1)
    m: torch.Tensor  # (1, L) per-pair max w; NaN where the level writes none
    apix: torch.Tensor  # (1, L) int32 its pixel; -1 where the level writes none


def _lane_scan(acc: torch.Tensor) -> torch.Tensor:
    """Inclusive product scan along the last axis in k_scan_fwd's log-step
    order: acc *= where(lane < s, 1, roll(acc, s)) for s = 1, 2, 4, ..."""
    lane = torch.arange(acc.shape[-1], device=acc.device)
    s = 1
    while s < acc.shape[-1]:
        acc = acc * torch.where(lane < s, 1.0, torch.roll(acc, s, dims=-1))
        s *= 2
    return acc


def _check_op(op: str, x: torch.Tensor) -> None:
    if op not in _OP_CODE:
        raise ValueError(f"unknown probe op {op!r}; one of {sorted(_OP_CODE)}")
    if x.dtype != torch.float32 or tuple(x.shape) != (TPX, RS):
        raise ValueError(f"probe_op takes a ({TPX}, {RS}) float32 tensor")


def probe_op(op: str, x: torch.Tensor) -> torch.Tensor:
    """K3: ``op`` (a key of PROBE_OPS) on ``x``; the CUDA kernel for a CUDA
    tensor, the twin for a CPU tensor."""
    _check_op(op, x)
    if x.device.type == "cpu":
        return probe_op_torch(op, x)
    if x.device.type != "cuda":
        raise ValueError(f"probe_op: unsupported device {x.device}")
    from gs2pc_torch.ops.cuda_build import check, load_library, stream_ptr

    lib = load_library()
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel moves float4s
        x = x.clone()
    out = torch.empty_like(x)
    rc = lib.gs2pc_probe_op(_OP_CODE[op], x.data_ptr(), out.data_ptr(), stream_ptr(x))
    probe_op.launches += 1
    probe_op.launches_by_op[op] += 1
    check(rc, "gs2pc_probe_op")
    return out


# Kernel launches, in all and by op; a caller resets them (= 0, .clear()).
probe_op.launches = 0
probe_op.launches_by_op = collections.Counter()


def probe_op_torch(op: str, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin of K3 (the TPU probe's kernel bodies)."""
    _check_op(op, x)
    if op == "row":
        return x.sum(dim=0, keepdim=True) * x
    col = x.sum(dim=1, keepdim=True)
    if op == "repeat":
        return col.expand(TPX, RS).contiguous()
    if op == "mul":
        return col * x
    if op == "dot":
        return col * torch.ones((1, RS), dtype=x.dtype, device=x.device)
    if op == "roll":
        return torch.roll(x, 4, dims=1)
    if op == "concat":
        return torch.nn.functional.pad(torch.cat([col, col, col], dim=1), (0, RS - 3))
    if op == "slice":
        return x + x[:, 0].sum()
    if op == "min":
        return x + x.min()
    return _lane_scan(x)


def _check_blend(level, starts, counts, dims, table, mask) -> None:
    if level not in LEVELS:
        raise ValueError(f"probe_blend level must be one of {LEVELS}")
    n = starts.shape[0]
    for name, t in (("starts", starts), ("counts", counts), ("dims", dims)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if counts.shape[0] != n or dims.shape[0] != 4 or not 1 <= n <= NTP:
        raise ValueError(f"starts / counts need one entry per tile (<= {NTP}), dims four")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 16:
        raise ValueError("table must be a (16, L) float32 tensor")
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (n, TPX, 1):
        raise ValueError(f"mask must be a ({n}, {TPX}, 1) uint8 tensor")
    for t in (counts, dims, table, mask):
        if t.device != starts.device:
            raise ValueError("all probe_blend inputs must be on one device")
    # Every chunk a tile can enter lies inside the table (the TPU kernel
    # copies whole 128-column chunks): one copy to the host, checked there.
    st, ct = torch.stack((starts, counts)).cpu().numpy().astype(np.int64)
    n_ch = np.where(ct > 0, (ct + RS - 1) // RS, 0)
    used = n_ch > 0
    if used.any() and (st[used].min() < 0 or (st + n_ch * RS)[used].max() > table.shape[1]):
        raise ValueError("a tile's chunks reach outside the table's columns")


def probe_blend(level: int, starts, counts, dims, table, mask) -> ProbeBlendResult:
    """K4 at ``level`` on try_level's argument layout: starts / counts
    (NTP,) int32 into the table's columns, dims [width, height, num_tiles,
    bg] int32, table (16, L) float32 (row 0 x, row 5 opacity), mask (NTP,
    256, 1) uint8.  The CUDA kernel for CUDA tensors, the twin for CPU
    tensors."""
    _check_blend(level, starts, counts, dims, table, mask)
    dev = table.device
    if dev.type == "cpu":
        return probe_blend_torch(level, starts, counts, dims, table, mask)
    if dev.type != "cuda":
        raise ValueError(f"probe_blend: unsupported device {dev}")
    from gs2pc_torch.ops.cuda_build import check, load_library, stream_ptr

    lib = load_library()
    n = starts.shape[0]
    L = table.shape[1]
    starts, counts, dims = starts.contiguous(), counts.contiguous(), dims.contiguous()
    table, mask = table.contiguous(), mask.contiguous()
    rgb = torch.empty((n, TPX, 3), dtype=torch.float32, device=dev)
    ed = torch.empty((n, TPX, 1), dtype=torch.float32, device=dev)
    einv = torch.empty_like(ed)
    m = torch.full((1, L), float("nan"), dtype=torch.float32, device=dev)
    apix = torch.full((1, L), -1, dtype=torch.int32, device=dev)
    rc = lib.gs2pc_probe_blend(
        level, n, starts.data_ptr(), counts.data_ptr(), dims.data_ptr(), table.data_ptr(),
        mask.data_ptr(), L, rgb.data_ptr(), ed.data_ptr(), einv.data_ptr(), m.data_ptr(),
        apix.data_ptr(), stream_ptr(table),
    )
    probe_blend.launches += 1
    check(rc, "gs2pc_probe_blend")
    return ProbeBlendResult(rgb, ed, einv, m, apix)


probe_blend.launches = 0


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the 128 lanes in the kernel's pairwise order: lane j adds
    lane j + h for h = 64, 32, ..., 1."""
    h = x.shape[-1] // 2
    while h >= 1:
        x = x[..., :h] + x[..., h:2 * h]
        h //= 2
    return x[..., 0]


def probe_blend_torch(level: int, starts, counts, dims, table, mask) -> ProbeBlendResult:
    """The plain PyTorch twin of K4, all tiles at once, chunk by chunk: a
    tile takes part in a chunk while it has chunks left and a pixel not
    done, as the TPU kernel's while loop."""
    _check_blend(level, starts, counts, dims, table, mask)
    dev = table.device
    n = starts.shape[0]
    L = table.shape[1]
    width, height, num_tiles, bg = (int(v) for v in dims.tolist())
    t = torch.arange(n, device=dev)
    tx, ty = t % GRID_W, t // GRID_W
    sub = torch.arange(TPX, device=dev)
    lane = torch.arange(RS, device=dev)
    gx = tx[:, None] * TILE + sub % TILE
    gy = ty[:, None] * TILE + sub // TILE
    pxf = gx.to(torch.float32)[:, :, None]
    valid = (gx < width) & (gy < height) & (t[:, None] < num_tiles) & (mask[:, :, 0] != 0)
    start, count = starts.long(), counts.long()
    n_chunks = torch.where(count > 0, (count + RS - 1) // RS, 0)

    T = torch.ones((n, TPX), device=dev)
    done = ~valid
    c_r = torch.zeros((n, TPX), device=dev)
    ed = torch.zeros((n, TPX), device=dev)
    m_out = torch.full((L,), float("nan"), device=dev)
    apix_out = torch.full((L,), -1, dtype=torch.int32, device=dev)
    for r in range(int(n_chunks.max()) if n else 0):
        active = (r < n_chunks) & ~done.all(dim=1)
        if not bool(active.any()):
            break
        cols = (start[:, None] + r * RS + lane).clamp(0, L - 1)  # (n, RS)
        x, opa = table[0][cols][:, None, :], table[5][cols][:, None, :]
        dx = pxf - x
        power = -0.5 * dx * dx
        alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
        if level >= 1:
            ok = ((power <= 0.0) & (alpha >= ALPHA_MIN)
                  & ((r * RS + lane)[None, None, :] < count[:, None, None]) & ~done[:, :, None])
        else:
            ok = alpha >= ALPHA_MIN
        a0 = torch.where(ok, alpha, 0.0)
        if level >= 2:
            acc = _lane_scan(1.0 - a0)
            cp_excl = torch.where(lane < 1, 1.0, torch.roll(acc, 1, dims=-1))
            t_before = T[:, :, None] * cp_excl
        else:
            t_before = 1.0 - a0
        w = a0 * t_before
        new_done = done
        if level >= 3:
            trigger = ok & (t_before * (1.0 - alpha) < T_EPS)
            new_done = done | trigger.any(dim=2)
        wsum = _lane_sum(w)
        new_T = T * torch.exp(_lane_sum(torch.log(1.0 - a0))) if level >= 4 else T
        sel = active[:, None]
        c_r = torch.where(sel, c_r + wsum, c_r)
        ed = torch.where(sel, ed + wsum, ed)
        T = torch.where(sel, new_T, T)
        done = torch.where(sel, new_done, done)
        if level >= 5:
            m = w.amax(dim=1)  # (n, RS)
            hit = (w >= m[:, None, :]) & (m[:, None, :] > 0.0)
            cand = torch.where(hit, sub[None, :, None], 2**20).amin(dim=1)
            s_best = torch.where(m > 0.0, cand, 0)
            apix = ((ty[:, None] * TILE + s_best // TILE) * WIDTH_PAD
                    + tx[:, None] * TILE + s_best % TILE)
            m_out[cols[active].reshape(-1)] = m[active].reshape(-1)
            apix_out[cols[active].reshape(-1)] = apix[active].reshape(-1).to(torch.int32)

    if level >= 6:
        rgb = torch.stack([torch.where(valid, c_r + T * float(bg), 0.0),
                           torch.where(valid, c_r, 0.0), torch.where(valid, c_r, 0.0)], dim=-1)
    else:
        rgb = torch.stack([c_r, c_r, c_r], dim=-1)
    return ProbeBlendResult(
        rgb=rgb,
        ed=torch.where(valid, ed, 0.0)[:, :, None],
        einv=ed[:, :, None],
        m=m_out[None, :],
        apix=apix_out[None, :],
    )
