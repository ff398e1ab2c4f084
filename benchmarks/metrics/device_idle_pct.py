"""device_idle_pct: the share of the traced window's wall in which nothing
ran on the card: 1 minus the union of the device intervals over the wall."""

from gsbench import trace


def read(run):
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    busy = trace.union_seconds(run.trace.device, lo, hi)
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e9)) if busy > 0 else None
