"""A throw-away checkout for the CPU tests: a copy of ``nsdp_bench`` beside
a ``BENCHMARK.json`` of the real cells at tiny sizes (the configurations'
widths and the traffic's sizes cut, every other key and every limit kept),
run through ``run_cell(..., device="cpu")`` in a fresh process: the
harness's look for a card is skipped, everything else of a run is done."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

TINY_MODEL = {
    "pointransformer": dict(npoints_per_layer=[64, 32, 16], nneighbor=8, nneighbor_reduced=6,
                            nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True),
    "pointnet++": dict(npoints_per_layer=[64, 32, 16], nneighbor=8, nfinal_transformers=1,
                       d_transformer=16),
}
TINY_DECODER = dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3)
TINY_TRAFFIC = {
    "serve": dict(pool=3, surface_points=64, queries=300, check_requests=2, trace_units=2),
    "drag": dict(pool=3, surface_points=64, queries={"low": 100, "high": 300, "dist": "uniform"},
                 drags=3, check_sessions=2, check_drags=2),
    "train": dict(pool=4, batch=2, surface_points=64, space_points=64, trace_units=2),
}


def checkout(tmp: Path, spec=None) -> Path:
    """``tmp`` made a checkout of the benchmark at tiny sizes -> its root."""
    shutil.copytree(BENCH, tmp / "nsdp_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = spec or json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["model"]["encoder_kwargs"] = TINY_MODEL[cfg["model"]["encoder"]]
        cfg["model"]["decoder_kwargs"] = TINY_DECODER
        path.write_text(json.dumps(cfg))
    for path in (tmp / "nsdp_bench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TINY_TRAFFIC[t["entry"]])
        path.write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run(root: Path, cell: str, seed: int = 5, seconds: float = 1.0, trace: bool = False,
        fault=None, timeout: float = 240.0) -> dict:
    """``run_cell`` of the checkout at ``root`` on the CPU, in a fresh
    process that finds the program on the repository's path."""
    code = ("import json, sys; from nsdp_bench.run import run_cell; "
            f"print(json.dumps(run_cell({cell!r}, {seed}, {seconds}, {trace}, device='cpu', "
            f"fault={fault!r})))")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"exit {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
