"""A short run of each cell on the card (skipped without one)."""

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_short_run_is_correct(card, cell):
    got = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 7), "--seconds", "3", "--trace", "1"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert line["metrics"]
