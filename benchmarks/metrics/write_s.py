"""write_s: seconds a conversion spends in the program's ply_write phase
(the points' chunked fetch and the native writer), over the window's
conversions."""


def read(run):
    return run.phase_mean("ply_write")
