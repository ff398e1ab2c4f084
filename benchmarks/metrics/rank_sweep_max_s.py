"""rank_sweep_max_s: seconds of the slowest rank's sweep phase in a
conversion (rank 0's sweep and each rank<r>/sweep that rank 0 files; each
ends with the gather of the accumulators), over the window's conversions;
none where no conversion ran on several ranks."""


def read(run):
    if not any("sweep" in c["phases"] for c in run.conversions):
        return None
    return sum(max((s for k, s in c["phases"].items() if k == "sweep" or k.endswith("/sweep")),
                   default=0.0) for c in run.conversions) / len(run.conversions)
