"""sweep_s: seconds a conversion spends in the program's render_sweep phase
(the camera batch, and per camera K6, K2, the key sort and K1), over the
window's conversions."""


def read(run):
    return run.phase_mean("render_sweep")
