"""k6_roofline_pct: K6's bound (bytes: 154 B a Gaussian with the compact
table, and the camera) over project_pack_kernel's device time in the
traced window."""

from gsbench import roofline, trace


def read(run):
    if run.trace is None or run.window_ns is None or not run.conversions:
        return None
    bound, _ = roofline.k6_bound(run.n_gaussians, run.renders * len(run.conversions))
    return roofline.share_pct(bound, trace.device_seconds(
        run.trace.device, lambda n: "project_pack_kernel" in n, *run.window_ns))
