"""On a card: the benchmark's harness drives the program's own CLI
(cli.main, which needs a card) at a tiny size and the reference calls the
run correct.  Skipped without a card."""

import pytest
import torch

import gsbench_tiny as tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["readme-mip", "full-colour"])
def test_cli_on_the_card_is_correct(card, mix):
    r = tiny.run(mix, device=card, trace=True)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
