"""A run as the command runs it: without a card it fails and prints no
result; so it does in a directory that holds only the benchmark."""

import shutil
import subprocess
import sys

from nsdp_bench.tests.tiny import BENCH, REPO

ARGS = ["-m", "nsdp_bench.run", "--workload", "arbitrary-serve-q65536", "--seed", "3",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the card's own tests run the cells
    proc = subprocess.run([sys.executable, *ARGS], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "nsdp_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
