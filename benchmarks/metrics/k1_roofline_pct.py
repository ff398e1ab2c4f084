"""k1_roofline_pct: K1's bound over blend_tiles_kernel's device time in the
traced window.

Operations: 256 pixels x (30 a pair the blend streamed + 3 a pair the
surface pass streamed), the pairs from the sweep's K1 work counters
(sweep_diag[4:7]: per tile the chunks K1 entered x run_chunk, within the
tile's capped count), every pixel of an entered chunk counted, done or
not, as chip_smoke.k1_bound counts them.  Bytes, a lower bound: 4 B a pair
read (its gid), 28 B a padded pixel (image 12, depth, inverse depth, final
and live T) and 12 B a Gaussian a render (key and surface distance); the
table rows are left out, so the bytes never inflate the bound.  None where
a conversion's sweep_diag lacks the work counters."""

from gsbench import roofline, trace

# chip_smoke.K1_BLEND_FLOPS, K1_SURF_FLOPS and TPX, frozen.
K1_BLEND_FLOPS = 30
K1_SURF_FLOPS = 3
TPX = 256
K1_BYTES_PER_PAIR = 4
K1_BYTES_PER_PIXEL = 28
K1_BYTES_PER_GAUSSIAN = 12


def k1_bound(streamed: float, surface: float, pixels: float, n_gaussians: int,
             renders: int) -> tuple:
    """K1 over ``renders`` camera renders of ``n_gaussians`` Gaussians whose
    blend streamed ``streamed`` pairs and surface pass ``surface`` pairs
    over ``pixels`` padded pixels in all."""
    return roofline.bound_seconds(
        K1_BYTES_PER_PAIR * max(streamed, surface) + K1_BYTES_PER_PIXEL * pixels
        + K1_BYTES_PER_GAUSSIAN * n_gaussians * renders,
        TPX * (K1_BLEND_FLOPS * streamed + K1_SURF_FLOPS * surface))


def read(run):
    if run.trace is None or run.window_ns is None or not run.conversions:
        return None
    if any(c["sweep_diag"] is None or len(c["sweep_diag"]) < 7 for c in run.conversions):
        return None
    streamed, surface, pixels = (sum(c["sweep_diag"][i] for c in run.conversions)
                                 for i in (4, 5, 6))
    bound, _ = k1_bound(streamed, surface, pixels, run.n_gaussians,
                        run.renders * len(run.conversions))
    return roofline.share_pct(bound, trace.device_seconds(
        run.trace.device, lambda n: "blend_tiles_kernel" in n, *run.window_ns))
