"""upload_host_s: host seconds a conversion spends in the program's
plane_upload span (each plane quantised, copied into pinned memory and its
upload enqueued, on the upload's worker thread), summed over the planes,
over the window's conversions; none where the program has no such span.
The worker runs beside the parse, so this time is not part of the parse's
wall."""


def read(run):
    if not any("plane_upload" in c["phases"] for c in run.conversions):
        return None
    return run.phase_mean("plane_upload")
