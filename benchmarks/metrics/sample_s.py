"""sample_s: seconds a conversion spends in the program's point_sampling and
surface_sampling phases (quotas, K5), over the window's conversions."""


def read(run):
    return run.phase_mean("point_sampling", "surface_sampling")
