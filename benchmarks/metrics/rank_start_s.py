"""rank_start_s: seconds of the slowest spawned rank's bring-up in a
conversion (its spmd_spawn_import, spmd_cuda_context, spmd_library_load and
spmd_group_init phases, which rank 0 files as rank<r>/<phase>), over the
window's conversions: 0.0 for a conversion whose ranks were already up;
none where no conversion ran on several ranks."""

BRINGUP = ("spmd_spawn_import", "spmd_cuda_context", "spmd_library_load", "spmd_group_init")


def per_rank(phases: dict) -> dict:
    """{rank: its bring-up seconds} of one conversion's phases."""
    out = {}
    for key, seconds in phases.items():
        rank, _, name = key.partition("/")
        if rank.startswith("rank") and name in BRINGUP:
            out[rank] = out.get(rank, 0.0) + seconds
    return out


def read(run):
    if not any(k.startswith("rank") for c in run.conversions for k in c["phases"]):
        return None
    return sum(max(per_rank(c["phases"]).values(), default=0.0)
               for c in run.conversions) / len(run.conversions)
