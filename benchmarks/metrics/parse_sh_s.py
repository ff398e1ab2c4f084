"""parse_sh_s: seconds a conversion spends in the program's ply_sh_rest span
(the 45 f_rest_* columns stacked into the SH coefficients), over the
window's conversions; none where the program has no such span."""


def read(run):
    if not any("ply_sh_rest" in c["phases"] for c in run.conversions):
        return None
    return run.phase_mean("ply_sh_rest")
