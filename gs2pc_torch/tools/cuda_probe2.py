"""K4 build-and-launch probe, the counterpart of tools/pallas_probe2.py: the
stripped-down blend at levels 0-6 through the CUDA kernel
(gs2pc_torch/csrc/probes.cu), held against the plain PyTorch twin.  One
line per level, ``level N: OK`` or ``level N: FAIL  [reason]``; OK means
the kernel launched and its outputs equal the twin's within RTOL (m and
apix where the level writes them, level >= 5).

    python -m gs2pc_torch.tools.cuda_probe2 [--device cuda:0] [--input ones|seeded]

``ones`` is try_level's input (every table entry 1, one 128-pair chunk per
tile); ``seeded`` draws x uniform(0, 64) and opacity uniform(0.05, 0.95),
runs of 0-256 pairs, a mask with ~10% of pixels off, 56 valid rows and a
last tile beyond num_tiles, so the stop trigger, the all-done exit and the
per-pair argmax fire.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from gs2pc_torch.ops.probe_kernels import (
    L_AL,
    LEVELS,
    NTP,
    RS,
    TPX,
    probe_blend,
    probe_blend_torch,
)

# Kernel and twin sum in the same pairwise order with the same operations; the
# bound allows for expf / logf rounding apart from torch's exp / log.
RTOL = 1e-5


def make_inputs(kind: str, device, seed: int = 0):
    """(starts, counts, dims, table, mask) of try_level or the seeded case."""
    if kind == "ones":
        starts = np.arange(NTP, dtype=np.int32) * RS
        counts = np.full(NTP, RS, np.int32)
        dims = np.array([64, 64, NTP, 1], np.int32)
        table = np.ones((16, L_AL), np.float32)
        mask = np.ones((NTP, TPX, 1), np.uint8)
    elif kind == "seeded":
        r = np.random.default_rng(seed)
        starts = np.arange(NTP, dtype=np.int32) * (2 * RS)
        counts = r.integers(0, 2 * RS + 1, NTP).astype(np.int32)
        counts[[0, NTP - 1]] = 2 * RS
        counts[3] = 0
        dims = np.array([64, 56, NTP - 1, 1], np.int32)
        table = r.uniform(0.0, 1.0, (16, L_AL)).astype(np.float32)
        table[0] = r.uniform(0.0, 64.0, L_AL)
        table[5] = r.uniform(0.05, 0.95, L_AL)
        mask = (r.uniform(size=(NTP, TPX, 1)) > 0.1).astype(np.uint8)
        mask[5] = 0  # a fully masked tile: done before its first chunk
    else:
        raise ValueError(f"unknown input {kind!r}")
    return tuple(torch.tensor(a, device=device) for a in (starts, counts, dims, table, mask))


def compare(level: int, got, want) -> float:
    """Largest relative difference of K4's outputs from the twin's; the m /
    apix outputs count only at level >= 5, where they must be written in
    the same places.  Raises on a mismatch the relative error cannot show."""
    errs = []
    for name in ("rgb", "ed", "einv") + (("m",) if level >= 5 else ()):
        a, b = getattr(got, name), getattr(want, name)
        if name == "m":
            written = ~torch.isnan(b)
            if not torch.equal(~torch.isnan(a), written):
                raise AssertionError("m written in other places")
            if not torch.equal(got.apix[written], want.apix[written]):
                raise AssertionError("apix differs")
            a, b = a[written], b[written]
        d = (a - b).abs()
        errs.append(float(torch.where(d > 0, d / b.abs(), 0.0).max()) if d.numel() else 0.0)
    return max(errs)


def try_level(level: int, inputs) -> dict:
    """One level: launch, compare with the twin, print its line."""
    try:
        got = probe_blend(level, *inputs)
        want = probe_blend_torch(level, *inputs)
        if inputs[0].device.type == "cuda":
            torch.cuda.synchronize(inputs[0].device)
        err = compare(level, got, want)
        abs_err = max(float((getattr(got, n) - getattr(want, n)).abs().max())
                      for n in ("rgb", "ed", "einv"))
        ok = bool(np.isfinite(err)) and err <= RTOL
        why = f"relative error {err:g} > {RTOL:g}"
    except Exception as e:  # noqa: BLE001 -- a probe reports, it does not stop
        ok, why, err, abs_err = False, str(e).splitlines()[-1][:100], float("nan"), float("nan")
    print(f"level {level}: OK" if ok else f"level {level}: FAIL  [{why}]", flush=True)
    return dict(ok=ok, rel_err=err, max_abs_err=abs_err)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run every level; returns {level: {ok, rel_err, max_abs_err}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--input", default="ones", choices=("ones", "seeded"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    inputs = make_inputs(args.input, torch.device(args.device), args.seed)
    return {level: try_level(level, inputs) for level in LEVELS}


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
