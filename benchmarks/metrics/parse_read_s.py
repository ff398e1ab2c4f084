"""parse_read_s: seconds a conversion spends in the program's ply_read span
(the export's header, the read of its vertex block and np.frombuffer into
records), over the window's conversions; none where the program has no
such span."""


def read(run):
    if not any("ply_read" in c["phases"] for c in run.conversions):
        return None
    return run.phase_mean("ply_read")
