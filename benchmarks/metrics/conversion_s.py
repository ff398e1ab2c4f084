"""conversion_s: the window's wall over the conversions completed in it,
every stall between and inside them included (host clock)."""


def read(run):
    return run.window_s / len(run.conversions) if run.conversions else None
