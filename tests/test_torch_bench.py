"""``python -m nsdp_tpu_torch.bench``, the port's counterpart of ``bench.py``,
on the CPU: its copies of the flagship config and the example batch, the
slope protocol, the JSON line against ``bench.py``'s keys and arithmetic,
every metric at a tiny size (``device="cpu"``, the captured path's
static-buffer contract), the train chain's reset, the FLOP count against
XLA's cost analysis of the JAX package's flax path, and the exit without a
card.  The card's numbers come only from a run on the card."""

import ast
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import __graft_entry__ as graft
import bench as jax_bench
from nsdp_tpu_torch import bench as port_bench

REPO = Path(__file__).resolve().parents[1]
TINY = graft.TINY_CONFIG


def test_flagship_config_is_the_graft_entry_one():
    assert port_bench.FLAGSHIP_CONFIG == graft.FLAGSHIP_CONFIG
    assert port_bench.QPS_Q == jax_bench.QPS_Q


@pytest.mark.parametrize("B,N,Q,seed", [(1, 50, 70, 0), (3, 40, 20, 5)])
def test_example_batch_is_the_graft_entry_one_bit_for_bit(B, N, Q, seed):
    got = port_bench._example_batch(B, N, Q, seed=seed)
    want = graft._example_batch(B, N, Q, seed=seed)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key


def test_slope_time_returns_the_per_call_cost(monkeypatch):
    """A fake chain on a fake clock: a fixed cost a chain plus a cost a
    call, and a reset whose cost lies outside the timed window."""
    now = [0.0]
    fixed, per_call = 0.026, 0.0195
    calls = []

    def run(k):
        calls.append(k)
        now[0] += fixed + per_call * k

    def reset():
        now[0] += 5.0

    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    assert port_bench.slope_time(run, K=20, n_rep=7) == pytest.approx(per_call, rel=1e-9)
    assert calls == [1] * 8 + [21] * 8  # one warm run and n_rep timed runs a length
    assert port_bench.slope_time(run, K=8, n_rep=5, reset=reset) == pytest.approx(per_call,
                                                                                  rel=1e-9)


def _bench_py_keys():
    """The keys of ``bench.py``'s ``result`` dict, in order, read with ast."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["result"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no result dict")


CANNED = {
    "qps": {"value": 3456789.123456, "spread": 0.0123456},
    "flops_per_eval": {"value": 381818210944.0},
    "train_step_ms_stage1_b16": {"value": 114.5678, "spread": 0.00456},
    "train_step_ms_stage1_bwd_b16": {"value": 108.0449, "spread": 0.0031},
    "train_step_ms_stage2_b8": {"value": 149.8049, "spread": 0.01},
    "train_step_ms_stage1_b16_bf16": {"value": 103.6, "spread": 0.0},
    "train_step_ms_stage1_bwd_b16_bf16": {"value": 99.95, "spread": 0.2},
    "train_step_ms_stage2_b8_bf16": {"value": 137.66, "spread": 0.00712},
    "drag_ms": {"value": 9.38765, "spread": 0.054321},
}


def _run_main(monkeypatch, capsys, fail=()):
    def measure(name, timeout):
        assert timeout == 600
        if name in fail:
            raise RuntimeError(f"exit 1: {name} broke")
        return dict(CANNED[name], metric=name)

    monkeypatch.setattr(port_bench, "setup_card", lambda: ("NVIDIA H100 80GB HBM3", 700.0))
    monkeypatch.setattr(port_bench, "measure_in_subprocess", measure)
    monkeypatch.delenv("NSDP_BENCH_METRIC_TIMEOUT", raising=False)
    rc = port_bench.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_prints_bench_py_line(monkeypatch, capsys):
    rc, line = _run_main(monkeypatch, capsys)
    assert rc == 0
    keys = _bench_py_keys()
    assert len(keys) == 20 and list(line)[:len(keys)] == keys
    extra = {"flops_per_eval", "peak_flops", "device", "power_limit_w", "graphs"}
    assert set(line) == set(keys) | extra
    qps, flops = CANNED["qps"]["value"], CANNED["flops_per_eval"]["value"]
    assert line["metric"] == "deformation_field_query_throughput"
    assert line["unit"] == "query_points/sec/chip"
    assert line["value"] == round(qps, 1) == 3456789.1
    assert line["vs_baseline"] == round(qps / 1e6, 4) == 3.4568
    assert line["spread"] == 0.0123
    assert line["mfu"] == round(flops * qps / (65536 * 67e12), 4)
    assert 0.2 < line["mfu"] < 0.4
    for key, digits in port_bench.SECONDARY:
        assert line[key] == round(CANNED[key]["value"], digits)
        assert line[key + "_spread"] == round(CANNED[key]["spread"], 4)
    assert line["train_step_ms_stage1_b16"] == 114.6 and line["drag_ms"] == 9.39
    assert (line["flops_per_eval"], line["peak_flops"]) == (flops, 67e12)
    assert (line["device"], line["power_limit_w"], line["graphs"]) == (
        "NVIDIA H100 80GB HBM3", 700.0, True)


@pytest.mark.parametrize("failed,nulls", [
    (("drag_ms",), ("drag_ms", "drag_ms_spread")),
    (("qps",), ("value", "vs_baseline", "spread", "mfu")),
    (("flops_per_eval", "train_step_ms_stage2_b8_bf16"),
     ("mfu", "train_step_ms_stage2_b8_bf16", "train_step_ms_stage2_b8_bf16_spread")),
])
def test_a_failed_metric_gives_null_its_error_and_exit_1(monkeypatch, capsys, failed, nulls):
    rc, line = _run_main(monkeypatch, capsys, fail=failed)
    assert rc == 1
    assert set(_bench_py_keys()) <= set(line)
    assert [k for k in _bench_py_keys() if line[k] is None] == list(nulls)
    errors = {k for k in line if k.endswith("_error")}
    want = {("value" if n == "qps" else "mfu" if n == "flops_per_eval" else n) + "_error"
            for n in failed}
    if "qps" in failed:
        want.add("mfu_error")
    assert errors == want
    assert all(line[k] for k in errors)


def test_metrics_are_bench_py_metrics():
    assert set(port_bench.METRICS) == {"qps"} | {k for k, _ in port_bench.SECONDARY}
    assert set(port_bench.TRAIN_METRICS) == {k for k, _ in port_bench.SECONDARY} - {"drag_ms"}


SMALL = dict(config=TINY, N=64, K=2, n_rep=1, device="cpu", graphs=True)


@pytest.mark.parametrize("measure", [port_bench.qps_measure, port_bench.drag_measure],
                         ids=["qps", "drag_ms"])
def test_evaluation_metrics_run_on_the_cpu(measure):
    value = measure(Q=96, **SMALL)()
    assert math.isfinite(value) and value > 0


@pytest.mark.parametrize("name", sorted(port_bench.TRAIN_METRICS))
def test_train_metrics_run_on_the_cpu(name):
    model_type, dtype, _ = port_bench.TRAIN_METRICS[name]
    value = port_bench.train_measure(model_type=model_type, compute_dtype=dtype, B=2, Q=64,
                                     **SMALL)()
    assert math.isfinite(value) and value > 0


def test_run_metric_prints_its_line(monkeypatch, capsys):
    """Child mode: the median, the spread and the values of the repeats."""
    values = iter([3.0, 1.0, 2.0])
    monkeypatch.setitem(port_bench.METRICS, "drag_ms", lambda: lambda: next(values))
    monkeypatch.setenv("NSDP_BENCH_REPEATS", "3")
    port_bench.run_metric("drag_ms")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["metric"], line["value"], line["spread"], line["values"]) == (
        "drag_ms", 2.0, 1.0, [3.0, 1.0, 2.0])
    assert set(line["launches"]) == {"K1", "K2", "K3", "K4", "gather"}


@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_train_chain_puts_its_start_state_back(model_type):
    """Two chains of the same length end at the same parameters, buffers
    and optimizer state, bit for bit, and the steps did move them."""
    chain = port_bench.train_chain(TINY, model_type, B=2, N=64, Q=64, device="cpu",
                                   graphs=True)

    def state():
        return [t.clone() for t in (*chain.model.parameters(), *chain.model.buffers())]

    chain.reset()
    start = state()
    ends = []
    for _ in range(2):
        chain.reset()
        value = chain.run(3)
        ends.append((value, state()))
    assert ends[0][0] == ends[1][0]
    assert all(torch.equal(a, b) for a, b in zip(ends[0][1], ends[1][1]))
    assert not all(torch.equal(a, b) for a, b in zip(start, ends[0][1]))


def test_flop_count_matches_xla_cost_analysis():
    """The torch count of the plain path's matrix products at flagship
    widths (N = 5000, Q = 4096) within [0.98, 1.00] of XLA's count of the
    flax path (``bench.analytic_flops_per_eval``), which also counts the
    elementwise work; the same on two seeds."""
    counts = [port_bench.flops_per_eval(N=5000, Q=4096, seed=s) for s in (0, 1)]
    assert counts[0] == counts[1]
    ratio = counts[0] / jax_bench.analytic_flops_per_eval(Q=4096)
    assert 0.98 <= ratio <= 1.00, ratio


@pytest.mark.parametrize("argv", [[], ["--metric", "qps"]], ids=["line", "child"])
def test_without_a_card_it_exits_before_timing(argv):
    proc = subprocess.run([sys.executable, "-m", "nsdp_tpu_torch.bench", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "none is available" in proc.stderr
    assert proc.stdout.strip() == ""
