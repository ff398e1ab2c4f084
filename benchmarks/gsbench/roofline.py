"""The yardstick of the kernels' roofline shares: the published peaks of one
NVIDIA H100 SXM and the work each kernel has to do, counted from shapes and
from the conversion's own counters, never from what a kernel reports it
skipped or from its launch layout.

The counts are frozen copies of the port's chip smoke test
(chip_smoke.k2_bound and chip_smoke.k6_bound with its K6_OPS and
K6_COMPACT_OPS) at the time this benchmark was written.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense float32 rate outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# K2 (csrc/pairs.cu): per Gaussian xy 8 B, r_alpha_sq 4, rect_min 8,
# rect_max 8, valid 1 and depth 4, read once; per pair an int64 key and an
# int32 gid written.
K2_BYTES_PER_GAUSSIAN = 33
K2_BYTES_PER_PAIR = 12

# K6 (csrc/project.cu): per Gaussian the mean, factor, opacity and alive
# flag (53 B) read; depth, xy, conic, the three radii (36 B), the rects and
# tiles touched (20 B) and valid (1 B) written; with a table also the colour
# (12 B) read and the row (4 B a lane) written; the camera (144 B) once.
# 291 float operations a Gaussian, 20 more to pack a compact row.
K6_IN_BYTES = 53
K6_OUT_BYTES = 57
K6_COLOUR_BYTES = 12
K6_CAMERA_BYTES = 144
K6_OPS = 291
K6_COMPACT_OPS = 20


def bound_seconds(n_bytes: float, n_ops: float) -> tuple:
    """(least seconds, what binds: "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def k2_bound(n_gaussians: int, renders: int, pairs: float) -> tuple:
    """K2 over ``renders`` camera renders of ``n_gaussians`` Gaussians that
    emitted ``pairs`` (tile, Gaussian) pairs in all."""
    return bound_seconds(K2_BYTES_PER_GAUSSIAN * n_gaussians * renders
                         + K2_BYTES_PER_PAIR * pairs, 0.0)


def k6_bound(n_gaussians: int, renders: int) -> tuple:
    """K6 over ``renders`` camera renders with the compact (8-lane) table,
    the one a conversion packs."""
    per = K6_IN_BYTES + K6_OUT_BYTES + K6_COLOUR_BYTES + 4 * 8
    return bound_seconds((per * n_gaussians + K6_CAMERA_BYTES) * renders,
                         (K6_OPS + K6_COMPACT_OPS) * n_gaussians * renders)


def share_pct(bound_s: float, device_s: float):
    """The bound as a percentage of the measured device time; None when the
    trace holds no time for the kernel."""
    return None if device_s <= 0.0 else 100.0 * bound_s / device_s
