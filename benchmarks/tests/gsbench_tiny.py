"""A cell at a size a CPU test can hold, and the program's CLI run on the
CPU twins (``cli.main`` refuses without a card): the helpers of the
benchmark's CPU tests."""

from __future__ import annotations

import contextlib
import json
import os
import sys
from unittest import mock

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from gsbench import harness  # noqa: E402

CONFIG = dict(name="tiny", gaussians=256, sh_degree=3, images=4, width=64, height=48,
              focal_scale=0.9)
LIMITS = json.load(open(os.path.join(BENCH, "checks", "mip360-room.full.json")))["limits"]


def traffic(name: str) -> dict:
    """A mix of the benchmark with a point budget a CPU test can sample."""
    t = json.load(open(os.path.join(BENCH, "traffic", f"{name}.json")))
    flags = list(t["flags"])
    flags[flags.index("--num_points") + 1] = "20000"
    return dict(t, flags=flags)


@contextlib.contextmanager
def on_cpu():
    """cli.main on the CPU: it sees a card and converts on the CPU twins."""
    from gs2pc_torch import cli

    orig = cli.convert_3dgs_to_pc

    def convert(*a, **k):
        k["device"] = torch.device("cpu")
        return orig(*a, **k)

    with mock.patch.object(cli.torch.cuda, "is_available", return_value=True), \
            mock.patch.object(cli, "convert_3dgs_to_pc", convert):
        yield


def run(mix: str = "full-colour", seed: int = 2**33 + 5, config: dict = CONFIG,
        trace: bool = False, sample: int = 4096, device: str = "cpu") -> dict:
    """One run of a tiny cell through harness.run_loaded, with the
    benchmark's metric entries and the room cell's limits."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    metrics = spec["per_layer"] if trace else spec["end_to_end"]
    cell = dict(name="tiny.cell", config=config["name"], traffic=mix, chips=1)
    return harness.run_loaded(cell, config, traffic(mix),
                              dict(sample=dict(uniform=sample, in_cloud=sample), limits=LIMITS),
                              metrics, seed, 0.5, trace, device=device, t_start=0.0)
