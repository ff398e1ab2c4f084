"""parse_columns_s: seconds a conversion spends in the program's ply_columns
spans (every plane the conversion uses taken out of the export's records,
and their hand-off to the upload), over the window's conversions; none
where the program has no such span."""


def read(run):
    if not any("ply_columns" in c["phases"] for c in run.conversions):
        return None
    return run.phase_mean("ply_columns")
