"""scene_broadcast_s: seconds rank 0 spends in the program's scene_broadcast
phase (the scene, cameras and SH sent from rank 0 to every rank of an SPMD
conversion), over the window's conversions; none where no conversion ran
on several ranks."""


def read(run):
    if not any("scene_broadcast" in c["phases"] for c in run.conversions):
        return None
    return run.phase_mean("scene_broadcast")
