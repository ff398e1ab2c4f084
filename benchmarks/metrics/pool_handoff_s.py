"""pool_handoff_s: host seconds rank 0 spends handing a conversion's job to
the ranks it keeps between conversions (the program's spmd_dispatch span)
and waiting, after its own part, for every rank's report (spmd_report),
over the window's conversions; none where the program has no such spans
(ranks started anew for every conversion)."""

SPANS = ("spmd_dispatch", "spmd_report")


def read(run):
    if not any(s in c["phases"] for c in run.conversions for s in SPANS):
        return None
    return run.phase_mean(*SPANS)
