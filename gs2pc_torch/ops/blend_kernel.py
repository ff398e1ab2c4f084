"""K1: the tile blend with fused per-Gaussian reductions (CUDA kernel in
gs2pc_torch/csrc/blend.cu) and its plain PyTorch twin.

Replaces gs2pc/ops/pallas_blend.py::_blend_kernel plus the reductions
rasterize._pair_reduce / _sd_reduce.  ``blend_tiles`` launches the kernel
for CUDA tensors and runs the twin only for CPU tensors; there is no
fallback between the two.

Inputs (one camera): the per-Gaussian blend table (rasterize.
pack_blend_table), the depth-sorted pair gids, per-tile run starts and
capped counts (0 for skipped tiles), and the row-major uint8 pixel mask or
None.  The depth-slab renderer's modes (gs2pc_torch.parallel.gauss_shard)
add a row-major (Hp * Wp,) starting-T map ``init_trans``, a surface-pass
depth map ``ed_override``, ``early_stop=False`` (the T < 1e-4 stop never
fires) and the background ``bg``.  Outputs (``BlendResult``): row-major
image / depth / invdepth / final T / live T, per tile the chunks the blend
entered, and per Gaussian the max contribution, the lowest padded pixel id
reaching it, and the min surface distance.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import torch

from gs2pc_torch.ops.blend import ALPHA_MAX, ALPHA_MIN, BACKGROUND, FLOAT_MAX, T_EPS, TILE

TPX = TILE * TILE
MAX_RUN_CHUNK = 256


class BlendResult(NamedTuple):
    image: torch.Tensor  # (Hp, Wp, 3)
    depth: torch.Tensor  # (Hp, Wp)
    invdepth: torch.Tensor  # (Hp, Wp)
    trans: torch.Tensor  # (Hp, Wp) final T (1 on invalid pixels)
    live: torch.Tensor  # (Hp, Wp) T on valid not-done pixels, else 0
    chunks: torch.Tensor  # (num_tiles,) int32 run_chunk steps the blend entered
    contrib: torch.Tensor  # (P,) max over pairs and pixels of alpha*T
    best_pix: torch.Tensor  # (P,) int64 lowest padded pixel id reaching it (0 if none)
    surf_dist: torch.Tensor  # (P,) min |depth - expected depth| (FLOAT_MAX if none)


def mode_of(init_trans, ed_override, early_stop: bool) -> str:
    """Which of K1's modes a call runs (the key of launches_by_mode)."""
    if not early_stop:
        return "early_stop=False"
    if ed_override is not None:
        return "ed_override"
    return "main" if init_trans is None else "init_trans"


def _check(table, sorted_gid, starts, counts, mask, num_tiles, width_pad, height_pad, run_chunk,
           init_trans, ed_override):
    dev = table.device
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] not in (8, 16):
        raise ValueError("table must be (P, 8) or (P, 16) float32")
    for name, t in (("sorted_gid", sorted_gid), ("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != num_tiles or counts.shape[0] != num_tiles:
        raise ValueError("starts / counts need one entry per tile")
    if mask is not None and (mask.dtype != torch.uint8 or mask.numel() != width_pad * height_pad):
        raise ValueError("mask must be a (Hp * Wp,) uint8 tensor")
    for name, t in (("init_trans", init_trans), ("ed_override", ed_override)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (width_pad * height_pad,)):
            raise ValueError(f"{name} must be a (Hp * Wp,) float32 tensor")
    maps = tuple(t for t in (mask, init_trans, ed_override) if t is not None)
    for t in (sorted_gid, starts, counts) + maps:
        if t.device != dev:
            raise ValueError("all blend inputs must be on one device")
    if not 1 <= run_chunk <= MAX_RUN_CHUNK:
        raise ValueError(f"run_chunk must lie in [1, {MAX_RUN_CHUNK}]")
    if width_pad % TILE or height_pad % TILE:
        raise ValueError("padded image dims must be multiples of 16")


def blend_tiles(
    table: torch.Tensor,
    sorted_gid: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    width: int,
    height: int,
    width_pad: int,
    height_pad: int,
    run_chunk: int,
    with_surface: bool,
    surface_compact: bool,
    init_trans: Optional[torch.Tensor] = None,
    ed_override: Optional[torch.Tensor] = None,
    early_stop: bool = True,
    bg: float = BACKGROUND,
) -> BlendResult:
    """Blend every tile of one camera; CUDA kernel for CUDA tensors, the
    PyTorch twin for CPU tensors."""
    grid_w = width_pad // TILE
    num_tiles = grid_w * (height_pad // TILE)
    _check(table, sorted_gid, starts, counts, mask, num_tiles, width_pad, height_pad, run_chunk,
           init_trans, ed_override)
    kw = dict(
        width=width, height=height, width_pad=width_pad, height_pad=height_pad,
        run_chunk=run_chunk, with_surface=with_surface, surface_compact=surface_compact,
        init_trans=init_trans, ed_override=ed_override, early_stop=early_stop, bg=bg,
    )
    if table.device.type == "cpu":
        return blend_tiles_torch(table, sorted_gid, starts, counts, mask, **kw)
    if table.device.type != "cuda":
        raise ValueError(f"blend_tiles: unsupported device {table.device}")
    from gs2pc_torch.ops.cuda_build import check, launch, load_library, stream_ptr

    lib = load_library()
    dev = table.device
    P = table.shape[0]
    # Locals keep every buffer alive until the launch is queued.  The kernel
    # copies table rows in 16-byte pieces, so the table must be 16-byte aligned.
    table, sorted_gid = table.contiguous(), sorted_gid.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()
    starts, counts = starts.contiguous(), counts.contiguous()
    mask, init_trans, ed_override = (
        None if t is None else t.contiguous() for t in (mask, init_trans, ed_override)
    )
    image = torch.empty((height_pad, width_pad, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((height_pad, width_pad), dtype=torch.float32, device=dev)
    invdepth = torch.empty_like(depth)
    trans = torch.empty_like(depth)
    live = torch.empty_like(depth)
    chunks = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    # Block i blends tile order[i]: the longest capped runs start first.
    order = torch.argsort(counts, descending=True).to(torch.int32)
    contrib = torch.empty(P, dtype=torch.float32, device=dev)
    best_pix = torch.empty(P, dtype=torch.int64, device=dev)
    surf = torch.empty(P, dtype=torch.float32, device=dev)
    rc = launch(
        lib.gs2pc_blend_tiles, table,
        table.data_ptr(), sorted_gid.data_ptr() if sorted_gid.numel() else None,
        starts.data_ptr(), counts.data_ptr(), order.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (mask, init_trans, ed_override)),
        int(early_stop), table.shape[1], num_tiles, width, height, grid_w, width_pad,
        run_chunk, float(bg), int(with_surface), int(surface_compact),
        image.data_ptr(), depth.data_ptr(), invdepth.data_ptr(), trans.data_ptr(),
        live.data_ptr(), chunks.data_ptr(), contrib.data_ptr(), best_pix.data_ptr(),
        surf.data_ptr(), P, stream_ptr(table),
    )
    blend_tiles.launches += 1
    blend_tiles.launches_by_mode[mode_of(init_trans, ed_override, early_stop)] += 1
    check(rc, "gs2pc_blend_tiles")
    return BlendResult(image, depth, invdepth, trans, live, chunks, contrib, best_pix, surf)


# Kernel launches, in all and by mode_of(); a caller resets them (= 0, .clear()).
blend_tiles.launches = 0
blend_tiles.launches_by_mode = collections.Counter()


def _untile(t: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """(num_tiles, 256, ...) tile-major -> (Hp, Wp, ...) row-major."""
    extra = t.shape[2:]
    t = t.reshape((grid_h, grid_w, TILE, TILE) + extra).transpose(1, 2)
    return t.reshape((grid_h * TILE, grid_w * TILE) + extra)


def blend_tiles_torch(
    table: torch.Tensor,
    sorted_gid: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    width: int,
    height: int,
    width_pad: int,
    height_pad: int,
    run_chunk: int,
    with_surface: bool,
    surface_compact: bool,
    init_trans: Optional[torch.Tensor] = None,
    ed_override: Optional[torch.Tensor] = None,
    early_stop: bool = True,
    bg: float = BACKGROUND,
) -> BlendResult:
    """The plain PyTorch twin of K1, on any device.

    Tiles go in batches; each batch walks its runs in ``run_chunk`` steps
    and, within a step, pair by pair front to back, vectorised over the
    batch's pixels.  Every float is computed with the kernel's operations in
    the kernel's order (which blend.cu writes without fused multiply-adds),
    so on one device the two agree to the bit wherever the exponential
    does.  Per-pair (max w, lowest pixel) values are reduced per Gaussian
    with scatter_reduce("amax") and a second "amin" pass over the pairs
    that reach the max; the surface distance with scatter_reduce("amin")."""
    dev = table.device
    P = table.shape[0]
    L = sorted_gid.shape[0]
    Rs = run_chunk
    grid_w, grid_h = width_pad // TILE, height_pad // TILE
    num_tiles = grid_w * grid_h
    compact = table.shape[1] == 8

    lid = torch.arange(TPX, device=dev)
    ly, lx = lid // TILE, lid % TILE
    lane = torch.arange(Rs, device=dev)
    out_rgb = torch.zeros((num_tiles, TPX, 3), device=dev)
    out_ed = torch.zeros((num_tiles, TPX), device=dev)
    out_einv = torch.zeros((num_tiles, TPX), device=dev)
    out_T = torch.ones((num_tiles, TPX), device=dev)
    out_live = torch.zeros((num_tiles, TPX), device=dev)
    out_chunks = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    surf = torch.full((P + 1,), FLOAT_MAX, device=dev)
    rec_gid, rec_m, rec_apix = [], [], []

    def chunk_rows(start, count, r):
        offs = r * Rs + lane
        in_run = offs[None, :] < count[:, None]
        idx = (start[:, None] + offs[None, :]).clamp(0, max(L - 1, 0))
        gid = torch.where(in_run, sorted_gid[idx].long(), 0) if L else torch.zeros_like(idx)
        return gid, in_run

    tb = max(1, (1 << 20) // TPX)
    for b0 in range(0, num_tiles, tb):
        tids = torch.arange(b0, min(b0 + tb, num_tiles), device=dev)
        ty, tx = tids // grid_w, tids % grid_w
        gx = tx[:, None] * TILE + lx[None, :]
        gy = ty[:, None] * TILE + ly[None, :]
        pixid = gy * width_pad + gx
        valid = (gx < width) & (gy < height)
        if mask is not None:
            valid = valid & (mask[pixid] != 0)
        pxf, pyf = gx.float(), gy.float()
        start, count = starts[tids].long(), counts[tids].long()

        T = torch.ones(valid.shape, device=dev) if init_trans is None else init_trans[pixid]
        done = ~valid
        rgb = torch.zeros(valid.shape + (3,), device=dev)
        ed = torch.zeros(valid.shape, device=dev)
        einv = torch.zeros(valid.shape, device=dev)
        n_stream = torch.zeros_like(count)
        n_steps = -(-int(count.max()) // Rs) if count.numel() else 0
        for r in range(n_steps):
            streaming = ~done.all(dim=1) & (r * Rs < count)
            if not bool(streaming.any()):
                break
            n_stream += streaming.long()
            gid, in_run = chunk_rows(start, count, r)
            in_run = in_run & streaming[:, None]
            rows = table[gid]  # (TB, Rs, lanes)
            if compact:
                v = rows[..., 7].to(torch.int32)
                col = torch.stack(
                    [((v >> 16) & 255).float(), ((v >> 8) & 255).float(), (v & 255).float()],
                    dim=-1,
                ) * (1.0 / 255.0)
            else:
                col = rows[..., 8:11]
            dep = rows[..., 6]
            inv_d = 1.0 / torch.where(dep.abs() < 1e-12, 1e-12, dep)
            m = torch.zeros(in_run.shape, device=dev)
            s_best = torch.zeros(in_run.shape, dtype=torch.int64, device=dev)
            n_j = min(Rs, int((count - r * Rs).max()))
            for j in range(n_j):
                row = rows[:, j, None, :]  # (TB, 1, lanes)
                dx = pxf - row[..., 0]
                dy = pyf - row[..., 1]
                power = -0.5 * (row[..., 2] * dx * dx + row[..., 4] * dy * dy) \
                    - row[..., 3] * dx * dy
                alpha = torch.clamp(row[..., 5] * torch.exp(power), max=ALPHA_MAX)
                ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_run[:, j, None] & ~done
                test_T = T * (1.0 - alpha)
                trigger = ok & (test_T < T_EPS) if early_stop else torch.zeros_like(ok)
                blend = ok & ~trigger
                w = torch.where(blend, alpha * T, 0.0)
                rgb = rgb + w[..., None] * col[:, j, None, :]
                ed = ed + w * dep[:, j, None]
                einv = einv + w * inv_d[:, j, None]
                T = torch.where(blend, test_T, T)
                done = done | trigger
                m[:, j] = w.amax(dim=1)
                s_best[:, j] = ((w >= m[:, j, None]) & (m[:, j, None] > 0.0)).int().argmax(dim=1)

            apix = ((ty[:, None] * TILE + s_best // TILE) * width_pad
                    + tx[:, None] * TILE + s_best % TILE)
            keep = in_run & (m > 0.0)
            rec_gid.append(gid[keep])
            rec_m.append(m[keep])
            rec_apix.append(apix[keep])

        sl = slice(b0, b0 + tids.shape[0])
        out_rgb[sl] = torch.where(valid[..., None], rgb + T[..., None] * bg, 0.0)
        ed_v = torch.where(valid, ed, 0.0)
        out_ed[sl] = ed_v
        out_einv[sl] = torch.where(valid, einv, 0.0)
        out_T[sl] = torch.where(valid, T, 1.0)
        out_live[sl] = torch.where(valid & ~done, T, 0.0)
        out_chunks[sl] = n_stream.to(torch.int32)

        if with_surface:
            ed_t = ed_v if ed_override is None else ed_override[pixid]
            cnt_s = torch.minimum(count, n_stream * Rs) if surface_compact else count
            n_surf = -(-int(cnt_s.max()) // Rs) if cnt_s.numel() else 0
            for r in range(n_surf):
                gid, in_run = chunk_rows(start, cnt_s, r)
                dep = table[gid, 6]
                dist = (dep[:, None, :] - ed_t[:, :, None]).abs()
                dist = torch.where(valid[:, :, None] & in_run[:, None, :], dist, FLOAT_MAX)
                sd = dist.amin(dim=1)
                tgt = torch.where(in_run, gid, P)
                surf.scatter_reduce_(0, tgt.reshape(-1), sd.reshape(-1), "amin")

    contrib = torch.zeros(P, device=dev)
    best = torch.full((P,), 1 << 62, dtype=torch.int64, device=dev)
    if rec_gid:
        g_all = torch.cat(rec_gid)
        m_all = torch.cat(rec_m)
        a_all = torch.cat(rec_apix)
        contrib.scatter_reduce_(0, g_all, m_all, "amax")
        win = m_all >= contrib[g_all]
        best.scatter_reduce_(0, g_all[win], a_all[win], "amin")
    best_pix = torch.where(contrib > 0.0, best, 0)
    return BlendResult(
        image=_untile(out_rgb, grid_h, grid_w),
        depth=_untile(out_ed, grid_h, grid_w),
        invdepth=_untile(out_einv, grid_h, grid_w),
        trans=_untile(out_T, grid_h, grid_w),
        live=_untile(out_live, grid_h, grid_w),
        chunks=out_chunks,
        contrib=contrib,
        best_pix=best_pix,
        surf_dist=surf[:P],
    )
