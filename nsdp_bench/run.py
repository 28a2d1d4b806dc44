"""Run one cell of the benchmark once, on the card it is started on.

    python -m nsdp_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration is the file its ``configs`` entry names, its traffic
``nsdp_bench/traffic/<traffic>.json``, whose ``entry`` names the module
``nsdp_bench/entries/<entry>.py`` that drives the program; its limits are
``nsdp_bench/limits/<cell>.json`` and each per-layer metric is read by
``nsdp_bench/metrics/<metric>.py``.  A new cell, configuration, traffic
mix or metric is new files and entries.

The run: seeded weights (``weights.py``) -> the program built and warmed
on the cell's shapes (set-up, ``setup_s`` from the process's start to the
first timed unit, less the reference's calibration of the weights) -> ``--seconds`` of units -> peak reserved memory read ->
with ``--trace 1`` the profiled slices read and the per-layer metrics
worked out -> the program freed -> the reference's comparison -> one JSON
line, the last on standard output, with each number compared beside its
limit under ``checks`` and again as the last lines on standard error.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits 2.  If ``jax``, ``jaxlib``, ``flax`` or
``nsdp_tpu`` (top-level module names, compared whole) is loaded once the
window has closed, it prints no result and exits 3.  Every cache the run
or the program writes lies inside the checkout (``.bench_cache/`` and the
program's own ``nsdp_tpu_torch/csrc/build/``).

``--control tf32`` (products in TF32 on the card, the nearest precision
below the configuration's) and ``--fault`` (a fault planted in the timed
path) are for the checks' own tests; a benchmark run takes neither.
"""

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "nsdp_tpu")
FAULTS = ("answer", "answer_alternate", "unchanged", "half_batch")


def process_start() -> float:
    """The wall-clock time this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(spec: Dict, cell: str):
    """-> (cell entry, configuration, traffic, limits)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell not in cells:
        raise SystemExit(f"nsdp_bench: no cell {cell!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[cell]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return (w, load_json(ROOT / config["file"]), load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            load_json(HERE / "limits" / f"{cell}.json"))


def metrics_of(spec: Dict, cell: str) -> Dict:
    """The cell's end-to-end metrics and its per-layer ones (those that
    list the cell, or list no cells and move a metric the cell reports)."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else True
    ends = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in ends}
    layers = [m for m in spec["per_layer"]
              if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": ends, "per_layer": layers}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def observation(win, entry, reading, work) -> SimpleNamespace:
    """What the per-layer readers read: ``slice``, the whole slice's
    reading (None if no slice is whole); the requests and seconds of the
    window outside the slices; ``matched_latency_s``, the mean over the
    slice's requests of the mean latency outside the slices of requests of
    the same kind (None where a kind never ran outside them); the unit's
    counted work (``work``) and the program's counters."""
    rest = [u for u in win.units if not u.traced]
    by_kind: Dict = {}
    for seconds, traced, kind in entry.calls:
        if not traced:
            by_kind.setdefault(kind, []).append(seconds)
    traced_kinds = [kind for _, traced, kind in entry.calls if traced]
    matched = None
    if traced_kinds and all(k in by_kind for k in traced_kinds):
        matched = sum(sum(by_kind[k]) / len(by_kind[k]) for k in traced_kinds) / len(traced_kinds)
    return SimpleNamespace(
        slice=reading if reading is not None and reading.whole else None,
        rest_requests=sum(u.requests for u in rest), rest_seconds=sum(u.seconds for u in rest),
        matched_latency_s=matched, work=work, counters=entry.counters())


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: Optional[str] = None, fault: Optional[str] = None,
             spec: Optional[Dict] = None) -> Dict:
    """One run of ``cell``; -> the result's fields.  ``device="cpu"`` runs
    the program's plain path (the tests; nothing is timed there that a
    result may report)."""
    import numpy as np
    import torch

    from nsdp_bench import harness
    from nsdp_bench import trace as tracing
    from nsdp_bench.reference.model import Reference
    from nsdp_bench.weights import calibrated_state

    spec = spec or load_json(ROOT / "BENCHMARK.json")
    w, cfg, traffic, limits = find(spec, cell)
    wanted = metrics_of(spec, cell)
    cuda = device != "cpu"
    set_tf32(control == "tf32")
    torch.set_num_threads(4)

    t0 = time.time()
    state = calibrated_state(cfg["model"], seed, device)
    initial = {k: v.clone() for k, v in state.items()}
    reference_s = time.time() - t0  # the reference's calibration: the check's, not set-up's
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spans = harness.Spans()
    module = load_module(HERE / "entries" / f"{traffic['entry']}.py",
                         f"nsdp_bench.entries.{traffic['entry']}")
    entry = module.Cell(cfg, traffic, seed, device, spans, fault)
    entry.setup(state)
    del state
    setup_s = time.time() - T_START - reference_s

    win = harness.window(seconds, entry.unit, trace, traffic.get("trace_units", 1), spans,
                         entry.programs, entry.sync)
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    e2e = dict(entry.e2e(win), setup_s=setup_s, peak_reserved_gib=peak / 2 ** 30)
    lat = np.percentile([c[0] * 1e3 for c in entry.calls if not c[1]], [50, 90, 95, 99, 100])
    entry.log("latency ms p50/p90/p95/p99/max " + " ".join(f"{x:.3f}" for x in lat)
              + f"; window {win.seconds:.3f} s, {len(win.units)} units")
    failed = entry.failed()
    attempted = sum(u.requests for u in win.units)

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        groups = harness.kernel_groups()
        reading = tracing.first_whole(win.slices, entry.programs.per_replay, groups)
        obs = observation(win, entry, reading, entry.work())
        for m in wanted["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"nsdp_bench_metric_{m['name']}")
            value = reader.read(obs)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        if reading is not None:
            device_info.update(busy_s=reading.busy_s, window_s=reading.wall_s)
            breakdown = {"device_ops": [[n, s] for n, s in reading.device_ops],
                         "idle_gaps": [[n, s] for n, s in reading.idle_gaps]}
            if not reading.whole:
                entry.log(f"nsdp_bench: the profiled slice is not whole: {reading.why}")
    else:
        for m in wanted["end_to_end"]:
            result["metrics"][m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    if trace:
        tracing.remove_traces(win.slices)
    if cuda:
        device_info["power_limit_w"] = power_limit()

    entry.release()
    set_tf32(False)
    t0 = time.time()
    readings = entry.readings(Reference(cfg["model"], initial))
    entry.log(f"readings (the reference took {time.time() - t0:.1f} s) " + json.dumps(readings))
    checks = {k: {"value": float(readings[k]), "limit": float(v)} for k, v in limits.items()}
    result["correct"] = bool(attempted > 0 and failed == 0
                             and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                                     for c in checks.values()))
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def set_tf32(on: bool):
    """TF32 products on the card (the control), or float32's."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def power_limit() -> Optional[float]:
    """The card's power limit in W (``nvidia-smi``), or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    args = ap.parse_args(argv)

    for name, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[name] = str(CACHE / sub)
    import torch

    spec = load_json(ROOT / "BENCHMARK.json")
    w = find(spec, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"nsdp_bench: the cell needs {w['chips']} CUDA card(s);"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control, fault=args.fault, spec=spec)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"nsdp_bench: loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
