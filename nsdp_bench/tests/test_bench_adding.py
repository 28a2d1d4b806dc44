"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and entries, and the harness finds and runs them by
name with no file it already has edited."""

import hashlib
import json

from nsdp_bench.tests import tiny

NEW_METRIC = '''"""Requests answered outside the profiled slices."""


def read(o):
    return float(o.rest_requests)
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "nsdp_bench").rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.checkout(tmp_path)
    before = digests(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "nsdp_bench/configs/nsdp-arbitrary.json").read_text())
    cfg["model"]["decoder_kwargs"]["nneigh"] = 4
    (root / "nsdp_bench/configs/nsdp-arbitrary-k4.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "nsdp_bench/traffic/serve-q65536.json").read_text())
    traffic["queries"] = {"low": 100, "high": 400, "dist": "loguniform"}
    (root / "nsdp_bench/traffic/serve-mixed.json").write_text(json.dumps(traffic))
    (root / "nsdp_bench/metrics/rest_requests.serve.py").write_text(NEW_METRIC)
    (root / "nsdp_bench/limits/k4-serve-mixed.json").write_text(
        (root / "nsdp_bench/limits/arbitrary-serve-q65536.json").read_text())
    spec["configs"].append({"name": "nsdp-arbitrary-k4", "source": "a test",
                            "file": "nsdp_bench/configs/nsdp-arbitrary-k4.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "k4-serve-mixed", "config": "nsdp-arbitrary-k4",
                              "traffic": "serve-mixed", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("query_points_per_s", "latency_ms_p95"):
            m["workloads"].append("k4-serve-mixed")
    spec["per_layer"].append({"name": "rest_requests.serve", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "serving",
                              "moves": "query_points_per_s", "workloads": ["k4-serve-mixed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traced = tiny.run(root, "k4-serve-mixed", trace=True)
    assert traced["correct"] and traced["metrics"]["rest_requests.serve"]["value"] > 0
    plain = tiny.run(root, "k4-serve-mixed")
    assert set(plain["metrics"]) == {"query_points_per_s", "latency_ms_p95", "peak_reserved_gib",
                                     "setup_s"}
    after = digests(root)
    assert all(after[p] == d for p, d in before.items())
    assert len(after) == len(before) + 4
