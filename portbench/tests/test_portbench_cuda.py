"""On the card: one short run of the command, whose last line is the
result with ``correct`` true (skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_one_short_run_is_correct(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "stress-glb-ris-1080p", "--seed", str(2**31 + 3), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
