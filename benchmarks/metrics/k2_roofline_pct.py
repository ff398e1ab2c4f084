"""k2_roofline_pct: K2's bound (bytes: 33 B a Gaussian a render and 12 B a
pair, the pairs being the sweep's blended pairs plus its run-cap drops)
over K2's device time (count_pairs_kernel + write_pairs_*) in the traced
window."""

from gsbench import roofline, trace


def _is_k2(name):
    return "count_pairs_kernel" in name or "write_pairs_" in name


def read(run):
    if run.trace is None or run.window_ns is None or not run.conversions:
        return None
    if any(c["sweep_diag"] is None for c in run.conversions):
        return None
    pairs = sum(c["sweep_diag"][0] + c["sweep_diag"][2] for c in run.conversions)
    bound, _ = roofline.k2_bound(run.n_gaussians, run.renders * len(run.conversions), pairs)
    return roofline.share_pct(bound, trace.device_seconds(run.trace.device, _is_k2,
                                                          *run.window_ns))
