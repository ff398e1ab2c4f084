"""sweep_busy_pct: the share of the render_sweep phases' wall in which some
kernel or copy ran on the card (the union of device intervals inside the
phase's ranges), from the window's trace."""

from gsbench import trace


def read(run):
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    spans = [s for s in run.trace.spans("render_sweep") if s.start_ns >= lo and s.end_ns <= hi]
    busy, wall = trace.busy_within(run.trace.device, spans)
    return 100.0 * busy / wall if wall > 0 and busy > 0 else None
