"""On the card: each cell at its own size, a short window, on the program
as it is (correct) and with its products in TF32, the nearest precision
below the configurations' float32 (not correct).  Run on the card with
``python -m pytest -m gpu nsdp_bench/tests``."""

import json
import subprocess
import sys

import pytest

from nsdp_bench.tests.tiny import REPO

CELLS = ["arbitrary-serve-q65536", "pointnet2-train-stage2-b8", "arbitrary-train-stage2-b8",
         "arbitrary-drag-sessions"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(cell, seed, *extra):
    proc = subprocess.run([sys.executable, "-m", "nsdp_bench.run", "--workload", cell, "--seed",
                           str(seed), "--seconds", "2", "--trace", "0", *extra], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not(card, cell):
    assert run(cell, 71)["correct"]
    control = run(cell, 72, "--control", "tf32")
    assert control["correct"] is False, control["checks"]
