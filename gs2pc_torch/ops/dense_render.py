"""Dense reference renderer, the exactness oracle (counterpart of
gs2pc.ops.dense_render.render_dense; the CLI's ``--renderer_type
dense|python``).

Every (pixel, Gaussian) pair is blended with gs2pc_torch.ops.blend.
blend_chunk, chunk by chunk in depth order: O(pixels x Gaussians), for
small scenes, tests, and as the oracle the tile renderer is held against.
Both axes are chunked (``chunk`` Gaussians x ``pixel_chunk`` pixels per
step), so the working set stays ~pixel_chunk * chunk floats whatever the
image size.  Plain PyTorch: the JAX package computes it in XLA too, outside
any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from gs2pc_torch.ops.blend import (
    BACKGROUND,
    FLOAT_MAX,
    TILE,
    RenderOutput,
    blend_chunk,
    init_carry,
)
from gs2pc_torch.ops.projection import preprocess


def render_dense(
    means: torch.Tensor,
    cov_factors: torch.Tensor,
    opacities: torch.Tensor,
    colours: torch.Tensor,
    alive: torch.Tensor,
    camera,
    width_pad: int,
    height_pad: int,
    chunk: int = 128,
    pixel_chunk: int = 1 << 16,
    calc_surface_distance: bool = True,
    mask: Optional[torch.Tensor] = None,  # (Hp * Wp,) uint8 / bool
    rect_cull: bool = False,  # blend only pairs whose tile lies in the Gaussian's rect
    block_range: Optional[tuple] = None,  # (lo, count) pixel-block band
) -> RenderOutput:
    """Exact dense render of one ``camera.Camera`` on the tensors' device.

    Gaussians go front to back in stable depth order, invalid ones last;
    chunks past the last valid Gaussian blend nothing and are skipped (the
    result is the same).  Per pixel block the per-Gaussian max contribution
    and its pixel combine across blocks with a strict ``>``, so the
    earliest block wins ties, as one full-image argmax would.  The surface
    pass measures, per Gaussian, the min |depth - expected depth| over the
    valid pixels of its tile rect.  ``block_range=(lo, count)`` renders
    only blocks lo .. lo + count - 1 (lo clamped so the band fits, as
    JAX's dynamic slice does): the image covers those rows (pick
    ``pixel_chunk`` a multiple of ``width_pad``) and the per-Gaussian
    outputs are partial.  Results come back in the Gaussians' order;
    ``n_dropped`` is None: the oracle never truncates."""
    dev = means.device
    P = means.shape[0]
    prep = preprocess(
        means, cov_factors, opacities, alive, camera,
        adaptive_radius=not calc_surface_distance,
    )

    sort_key = torch.where(prep.valid, prep.depth, FLOAT_MAX)
    order = torch.argsort(sort_key, stable=True)
    n_valid = int(prep.valid.sum())
    n_chunks = -(-n_valid // chunk)
    p_pad = n_chunks * chunk
    kept = order[:min(P, p_pad)]

    def pad(x, fill=0):
        x = x[kept]
        if p_pad > x.shape[0]:
            tail = torch.full((p_pad - x.shape[0],) + tuple(x.shape[1:]), fill,
                              dtype=x.dtype, device=dev)
            x = torch.cat([x, tail])
        return x

    s_xy, s_conic, s_op = pad(prep.xy), pad(prep.conic), pad(prep.opacity)
    s_col, s_depth = pad(colours), pad(prep.depth)
    s_valid = pad(prep.valid, fill=False)
    s_rmin, s_rmax = pad(prep.rect_min), pad(prep.rect_max)

    npx = height_pad * width_pad
    blk = min(pixel_chunk, npx)
    n_blk = -(-npx // blk)
    npx_pad = n_blk * blk
    pix = torch.arange(npx_pad, device=dev)
    ys, xs = pix // width_pad, pix % width_pad
    px_all = torch.stack([xs, ys], dim=-1).to(torch.float32)
    valid_all = (xs < camera.width) & (ys < camera.height) & (pix < npx)
    if mask is not None:
        mask_pad = torch.zeros(npx_pad, dtype=mask.dtype, device=dev)
        mask_pad[:npx] = mask.reshape(-1)
        valid_all = valid_all & (mask_pad != 0)

    blocks = range(n_blk)
    if block_range is not None:
        lo, n_sel = int(block_range[0]), int(block_range[1])
        lo = min(max(lo, 0), n_blk - n_sel)
        blocks = range(lo, lo + n_sel)

    m_run = torch.zeros(p_pad, device=dev)
    apix_run = torch.zeros(p_pad, dtype=torch.int64, device=dev)
    sd_run = torch.full((p_pad,), FLOAT_MAX, device=dev)
    img_b, ed_b, einv_b = [], [], []
    for b in blocks:
        px = px_all[b * blk:(b + 1) * blk]
        valid_px = valid_all[b * blk:(b + 1) * blk]
        tile_xy = torch.floor(px / TILE).to(torch.int32)
        carry = init_carry((blk,), ~valid_px)
        m_blk = torch.zeros(p_pad, device=dev)
        arg_blk = torch.zeros(p_pad, dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            pair_mask = None
            if rect_cull:
                rmin, rmax = s_rmin[sl], s_rmax[sl]
                pair_mask = (
                    (tile_xy[:, None, 0] >= rmin[None, :, 0])
                    & (tile_xy[:, None, 0] < rmax[None, :, 0])
                    & (tile_xy[:, None, 1] >= rmin[None, :, 1])
                    & (tile_xy[:, None, 1] < rmax[None, :, 1])
                )
            carry, w = blend_chunk(
                carry, px, s_xy[sl], s_conic[sl], s_op[sl], s_col[sl], s_depth[sl],
                s_valid[sl], pair_mask=pair_mask,
            )
            m_blk[sl], arg_blk[sl] = torch.max(w, dim=0)  # first pixel on ties

        upd = m_blk > m_run
        m_run = torch.where(upd, m_blk, m_run)
        apix_run = torch.where(upd, b * blk + arg_blk, apix_run)

        img_b.append(torch.where(
            valid_px[:, None], carry.colour + carry.transmittance[:, None] * BACKGROUND, 0.0))
        ed_blk = torch.where(valid_px, carry.exp_depth, 0.0)
        ed_b.append(ed_blk)
        einv_b.append(torch.where(valid_px, carry.exp_invdepth, 0.0))

        if calc_surface_distance:
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                rmin, rmax = s_rmin[sl] * TILE, s_rmax[sl] * TILE
                in_rect = (
                    (px[:, None, 0] >= rmin[None, :, 0])
                    & (px[:, None, 0] < rmax[None, :, 0])
                    & (px[:, None, 1] >= rmin[None, :, 1])
                    & (px[:, None, 1] < rmax[None, :, 1])
                    & valid_px[:, None]
                    & s_valid[sl][None, :]
                )
                dist = torch.where(in_rect, (s_depth[sl][None, :] - ed_blk[:, None]).abs(),
                                   FLOAT_MAX)
                sd_run[sl] = torch.minimum(sd_run[sl], dist.amin(dim=0))

    img_flat, ed_flat, einv_flat = torch.cat(img_b), torch.cat(ed_b), torch.cat(einv_b)
    if block_range is not None:
        out_h = img_flat.shape[0] // width_pad
    else:
        img_flat, ed_flat, einv_flat = img_flat[:npx], ed_flat[:npx], einv_flat[:npx]
        out_h = height_pad

    n = kept.shape[0]
    contrib = torch.zeros(P, device=dev)
    contrib[kept] = m_run[:n]
    best_pix = torch.zeros(P, dtype=torch.int64, device=dev)
    best_pix[kept] = apix_run[:n]
    best_pix = best_pix.clamp(0, npx - 1)
    if block_range is not None:
        # best_pix is a global pixel id; only the band's rows exist.
        best_colour = torch.zeros((P, 3), device=dev)
    else:
        best_colour = torch.where((contrib > 0.0)[:, None], img_flat[best_pix], 0.0)
    surf = torch.full((P,), FLOAT_MAX, device=dev)
    if calc_surface_distance:
        surf[kept] = sd_run[:n]

    return RenderOutput(
        image=img_flat.reshape(out_h, width_pad, 3),
        depth=ed_flat.reshape(out_h, width_pad),
        invdepth=einv_flat.reshape(out_h, width_pad),
        radii=prep.radius,
        contrib=contrib,
        best_colour=best_colour,
        surf_dist=surf,
    )
