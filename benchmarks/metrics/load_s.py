"""load_s: seconds a conversion spends in the program's load_gaussians
phase (the export's parse and the planes' upload), over the window's
conversions."""


def read(run):
    return run.phase_mean("load_gaussians")
