"""Front-to-back compositing: the constants, the per-camera render product
and the chunk blend of the dense oracle (counterpart of gs2pc.ops.blend).

Blend semantics, shared by the CUDA tile kernel and its PyTorch twin
(gs2pc_torch.ops.blend_kernel): power = -0.5 (A dx^2 + C dy^2) - B dx dy,
skipped if > 0; alpha = min(0.99, opacity exp(power)), skipped if < 1/255;
if T (1 - alpha) < 1e-4 the pixel is done and that Gaussian is NOT
composited; otherwise w = alpha T is composited and T *= 1 - alpha.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16  # tile edge in pixels; one CUDA block of TILE * TILE threads per tile
BACKGROUND = 1.0  # white, as the JAX sweep renders by default
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
FLOAT_MAX = float(torch.finfo(torch.float32).max)


class RenderOutput(NamedTuple):
    """Per-camera render products (padded image dims)."""

    image: torch.Tensor  # (Hp, Wp, 3)
    depth: torch.Tensor  # (Hp, Wp) expected depth
    invdepth: torch.Tensor  # (Hp, Wp) expected inverse depth
    radii: torch.Tensor  # (P,) pixel radii
    contrib: torch.Tensor  # (P,) per-image max contribution alpha*T
    best_colour: torch.Tensor  # (P, 3) rendered colour at the argmax pixel
    surf_dist: torch.Tensor  # (P,) min |depth_g - expected depth|, FLOAT_MAX if none
    # Populated on request, for the depth-slab renderer: the final per-pixel
    # transmittance (its cross-slab prefix) and each Gaussian's best pixel
    # (to re-gather its colour from the combined image).
    trans: Optional[torch.Tensor] = None  # (Hp, Wp)
    best_pix: Optional[torch.Tensor] = None  # (P,) int64 padded row-major pixel id
    # (4,) f64 counters [pairs blended, window-truncated (always 0 on one
    # camera; slab overflow on the depth-slab path), run-cap-dropped pairs,
    # run-cap drops on tiles with live pixels].  Float64 keeps the sums of
    # pair counts exact past 2^24.
    n_dropped: Optional[torch.Tensor] = None
    # (3,) f64 K1's work on the camera [pairs the blend streamed (per tile
    # the chunks it entered x run_chunk, within the capped count), pairs the
    # surface pass streamed, padded pixels]; None where the tile renderer's
    # K1 did not run for this camera alone (the dense oracle, the depth-slab
    # renderer).
    k1_work: Optional[torch.Tensor] = None


class BlendCarry(NamedTuple):
    """Per-pixel state of the chunked blend."""

    transmittance: torch.Tensor  # (..., Npx)
    done: torch.Tensor  # (..., Npx) bool
    colour: torch.Tensor  # (..., Npx, 3)
    exp_depth: torch.Tensor  # (..., Npx)
    exp_invdepth: torch.Tensor  # (..., Npx)


def init_carry(
    shape_px: tuple, done0: torch.Tensor, t0: Optional[torch.Tensor] = None
) -> BlendCarry:
    """The carry of ``shape_px`` pixels on ``done0``'s device; ``t0`` seeds
    their transmittance (default 1)."""
    f32 = dict(dtype=torch.float32, device=done0.device)
    shape = tuple(shape_px)
    return BlendCarry(
        transmittance=torch.ones(shape, **f32) if t0 is None else t0,
        done=done0,
        colour=torch.zeros(shape + (3,), **f32),
        exp_depth=torch.zeros(shape, **f32),
        exp_invdepth=torch.zeros(shape, **f32),
    )


def _scan_incl_prod_(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product scan along the last axis in gs2pc.ops.blend's
    Hillis-Steele log-step order (acc[j] *= acc[j - s] for s = 1, 2, 4,
    ...), so the stop test sees the same T as the JAX blend.  Ping-pongs
    between ``x`` (overwritten) and one buffer."""
    acc, buf = x, torch.empty_like(x)
    n = x.shape[-1]
    s = 1
    while s < n:
        buf[..., :s] = acc[..., :s]
        torch.mul(acc[..., s:], acc[..., :-s], out=buf[..., s:])
        acc, buf = buf, acc
        s *= 2
    return acc


def blend_chunk(
    carry: BlendCarry,
    px: torch.Tensor,  # (..., Npx, 2) pixel centres
    xy: torch.Tensor,  # (..., C, 2) Gaussian centres, depth-ordered
    conic: torch.Tensor,  # (..., C, 3)
    opacity: torch.Tensor,  # (..., C)
    colour: torch.Tensor,  # (..., C, 3)
    depth: torch.Tensor,  # (..., C)
    alive: torch.Tensor,  # (..., C) bool
    pair_mask: Optional[torch.Tensor] = None,  # (..., Npx, C) bool
    early_stop: bool = True,
):
    """Composite one depth-ordered chunk of Gaussians into a block of
    pixels, every (pixel, Gaussian) pair at once (gs2pc.ops.blend.blend_chunk).

    The sequential early exit becomes a per-pixel ``done`` flag: a pair at
    or after the first trigger (T (1 - alpha) < 1e-4) on its pixel gets no
    weight.  Returns (new carry, w) with w (..., Npx, C) each pair's
    contribution alpha * T (0 where skipped).  ``early_stop=False`` turns
    the trigger off.  The weighted colour, depth and inverse-depth sums are
    one matrix product over the chunk (full float32: the caller keeps TF32
    off, pipeline.set_precision)."""
    dx = px[..., :, None, 0] - xy[..., None, :, 0]
    dy = px[..., :, None, 1] - xy[..., None, :, 1]
    A = conic[..., None, :, 0]
    B = conic[..., None, :, 1]
    Cc = conic[..., None, :, 2]
    power = -0.5 * (A * dx * dx + Cc * dy * dy) - B * dx * dy
    alpha = torch.clamp(opacity[..., None, :] * torch.exp(power), max=ALPHA_MAX)

    ok = power <= 0.0
    ok &= alpha >= ALPHA_MIN
    ok &= alive[..., None, :]
    ok &= ~carry.done[..., :, None]
    if pair_mask is not None:
        ok &= pair_mask
    a0 = torch.where(ok, alpha, 0.0)

    # T before each pair: T times the exclusive product of (1 - a0), i.e.
    # T for the first pair and T x the inclusive scan shifted by one after.
    incl = _scan_incl_prod_(1.0 - a0)
    T = carry.transmittance[..., :, None]
    t_before = torch.empty_like(incl)
    t_before[..., :1] = T
    torch.mul(T, incl[..., :-1], out=t_before[..., 1:])
    del incl
    if early_stop:
        trigger = ok & (t_before * (1.0 - alpha) < T_EPS)
        # Inclusive running "any" along the chunk: exact, in any order.
        seen = torch.cumsum(trigger, dim=-1, dtype=torch.int32) > 0
        a_used = torch.where(seen, 0.0, a0)
        new_done = carry.done | trigger.any(dim=-1)
    else:
        a_used = a0
        new_done = carry.done
    w = a_used * t_before

    inv_d = 1.0 / torch.where(depth.abs() < 1e-12, 1e-12, depth)
    rows = torch.cat([colour, depth[..., None], inv_d[..., None]], dim=-1)  # (..., C, 5)
    sums = torch.matmul(w, rows)  # (..., Npx, 5)
    new_carry = BlendCarry(
        transmittance=carry.transmittance * torch.prod(1.0 - a_used, dim=-1),
        done=new_done,
        colour=carry.colour + sums[..., :3],
        exp_depth=carry.exp_depth + sums[..., 3],
        exp_invdepth=carry.exp_invdepth + sums[..., 4],
    )
    return new_carry, w
