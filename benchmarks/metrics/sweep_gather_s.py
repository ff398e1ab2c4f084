"""sweep_gather_s: seconds rank 0 spends in the program's gather phase (every
rank's accumulators gathered and merged after its share of the cameras),
over the window's conversions; none where no conversion ran on several
ranks."""


def read(run):
    if not any("gather" in c["phases"] for c in run.conversions):
        return None
    return run.phase_mean("gather")
