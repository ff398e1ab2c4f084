"""K3 build-and-launch probe, the counterpart of tools/pallas_probe.py: each
of its nine ops runs through the CUDA kernel (gs2pc_torch/csrc/probes.cu)
and is held against the plain PyTorch twin.  One line per case,
``name: OK`` or ``name: FAIL  [reason]``; OK means the kernel launched and
equals its twin (bit for bit for the exact ops, within RTOL elsewhere).

    python -m gs2pc_torch.tools.cuda_probe [--device cuda:0] [--input ones|uniform]

On ``--device cpu`` the wrapper runs the twin, so the lines check the
twin's shapes and the tool's plumbing only.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from gs2pc_torch.ops.probe_kernels import EXACT_OPS, PROBE_OPS, RS, TPX, probe_op, probe_op_torch

# The ops that sum do it in another order in the kernel (warp shuffles, a
# column walk) than in the twin: a few ulps of a sum of up to 256 terms.
RTOL = 1e-5


def make_input(kind: str, device, seed: int = 0) -> torch.Tensor:
    """The TPU tool's input (ones) or a seeded uniform(0.5, 1.5) block."""
    if kind == "ones":
        x = np.ones((TPX, RS), np.float32)
    elif kind == "uniform":
        x = np.random.default_rng(seed).uniform(0.5, 1.5, (TPX, RS)).astype(np.float32)
    else:
        raise ValueError(f"unknown input {kind!r}")
    return torch.tensor(x, device=device)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / |want| (0 where both are 0)."""
    d = (got - want).abs()
    return float(torch.where(d > 0, d / want.abs(), 0.0).max())


def run(name: str, op: str, x: torch.Tensor) -> dict:
    """One case: launch, compare with the twin, print its line."""
    try:
        got = probe_op(op, x)
        want = probe_op_torch(op, x)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        err = rel_err(got, want)
        abs_err = float((got - want).abs().max())
        if not np.isfinite(err):
            ok, why = False, "non-finite"
        elif op in EXACT_OPS:
            ok, why = abs_err == 0.0, f"differs from its twin by {abs_err:g}"
        else:
            ok, why = err <= RTOL, f"relative error {err:g} > {RTOL:g}"
    except Exception as e:  # noqa: BLE001 -- a probe reports, it does not stop
        ok, why, err, abs_err = False, str(e).splitlines()[-1][:100], float("nan"), float("nan")
    print(f"{name}: OK" if ok else f"{name}: FAIL  [{why}]", flush=True)
    return dict(ok=ok, rel_err=err, max_abs_err=abs_err)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run every case; returns {case name: {ok, rel_err, max_abs_err}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--input", default="ones", choices=("ones", "uniform"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    x = make_input(args.input, torch.device(args.device), args.seed)
    return {name: run(name, op, x) for name, op in PROBE_OPS}


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
