"""The program's spans read beside a slice's trace (``program_spans``), on
a synthetic Chrome trace with correlation ids and synthetic spans: the
clock check's margin, the idle time inside replays' device windows, the
idle pieces named after the innermost program span and partitioning the
slice's idle time, the host-bound time of serving calls and of train
steps; a replay whose device records were lost gives no graph number.
Then the cell ``arbitrary-serve-mixed-q`` at tiny sizes on the CPU: its
traced run reads the padded rows and the host-bound time from the
program's tracer, its untraced run never turns the tracer on."""

from nsdp_bench import harness, program_spans
from nsdp_bench.tests import tiny
from nsdp_tpu_torch.utils.profiling import Span

OFFSET = 7_000_000.0  # trace clock minus host clock, us
US = 1000  # ns


def device(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "attn_kernel", "ts": ts + OFFSET, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr, dur=4):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts + OFFSET,
            "dur": dur, "args": {"correlation": corr}}


def call_spans(t0, first_id, request, root="serve.deform"):
    """A call at host time t0 (us): its root [t0, t0 + 100], padding
    [t0, t0 + 10], staging [t0 + 10, t0 + 15], the replay's launch
    [t0 + 15, t0 + 25], the wait [t0 + 25, t0 + 90], the fetch to the end."""
    parts = [("serve.pad", 0, 10, None), ("graphs.stage", 10, 15, "deform"),
             ("graphs.replay", 15, 25, "deform"), ("serve.wait", 25, 90, None),
             ("serve.fetch", 90, 100, None)]
    out = [Span(first_id, root, t0 * US, (t0 + 100) * US, None, request, None)]
    out += [Span(first_id + 1 + i, n, (t0 + a) * US, (t0 + b) * US, first_id, request, d)
            for i, (n, a, b, d) in enumerate(parts)]
    return out


def replay_events(t0, corr):
    """The launch at t0 + 18 (4 us); the replay's kernels at [t0 + 30, 50]
    and [t0 + 60, 85]: its window 55 us, 10 us idle inside it."""
    return [launch(t0 + 18, corr), device(t0 + 30, 20, corr), device(t0 + 60, 25, corr)]


def slice_of(replays_counted=2, n=2):
    s = harness.Slice(n=n, requests=n, start=0.0, end=300e-6)
    s.spans = [("deform", 5e-6, 115e-6), ("deform", 145e-6, 255e-6)]
    s.replays = {1: replays_counted}
    return s


def spans_and_events():
    spans = call_spans(10, 0, 0) + call_spans(150, 10, 1)
    events = replay_events(10, 101) + replay_events(150, 102)
    return spans, events


def test_slice_read_beside_the_trace():
    spans, events = spans_and_events()
    r = program_spans.read_slice(events, slice_of(), spans, OFFSET)
    assert r["replays_found"] == r["replays_counted"] == 2
    assert r["clock"] == "sync"
    assert r["clock_margin_us"] == 3  # each launch [28, 32] inside its span [25, 35]
    assert r["graph_idle_ms"] == 10e-3  # per unit, inside the replay's window
    assert r["replay_window_ms"] == 55e-3
    # per call: 30 us idle before its replay's kernels (pad, stage, launch,
    # part of the wait), 15 us after them (wait, fetch); the benchmark's
    # span 5 us before and 5 after; the harness the rest of 300 us
    names = r["idle_by_name_ms"]
    assert abs(names["replay:deform"] - 10e-3) < 1e-12
    assert abs(names["serve.pad"] - 10e-3) < 1e-12 and abs(names["graphs.stage"] - 5e-3) < 1e-12
    assert abs(names["graphs.replay"] - 10e-3) < 1e-12
    assert abs(names["serve.wait"] - 10e-3) < 1e-12 and abs(names["serve.fetch"] - 10e-3) < 1e-12
    assert abs(r["program_idle_ms"] - 45e-3) < 1e-12
    assert abs(r["bench_idle_ms"] - 10e-3) < 1e-12 and abs(r["harness_idle_ms"] - 40e-3) < 1e-12
    total = r["graph_idle_ms"] + r["program_idle_ms"] + r["bench_idle_ms"] + r["harness_idle_ms"]
    assert abs(total * 2 - r["idle_ms"]) < 1e-12 and abs(r["idle_ms"] - (300 - 90) * 1e-3) < 1e-12
    assert r["host_bound_train_ms"] is None


def test_a_lost_replay_gives_no_graph_number():
    spans, events = spans_and_events()
    events = [e for e in events if e["args"]["correlation"] != 102 or e["cat"] != "kernel"]
    r = program_spans.read_slice(events, slice_of(), spans, OFFSET)
    assert r["replays_found"] == 1 and r["replays_counted"] == 2
    assert r["graph_idle_ms"] is None and r["replay_window_ms"] is None
    assert r["clock_margin_us"] is None  # two replay spans, one launch: no pairing
    assert "replay:?" in r["idle_by_name_ms"]
    spans, events = spans_and_events()
    assert program_spans.read_slice(events, slice_of(3), spans, OFFSET)["graph_idle_ms"] is None


def test_a_late_anchor_gives_way_to_the_launches():
    spans, events = spans_and_events()
    good = program_spans.read_slice(events, slice_of(), spans, OFFSET)
    r = program_spans.read_slice(events, slice_of(), spans, OFFSET + 20)
    assert good["clock"] == "sync" and r["clock"] == "launches"
    assert r["clock_margin_sync_us"] == -17 and r["clock_margin_us"] == 3
    assert r["idle_by_name_ms"] == good["idle_by_name_ms"]
    events[0]["ts"] += 12  # the first launch 12 us later: no one offset holds both
    r = program_spans.read_slice(events, slice_of(), spans, OFFSET + 20)
    assert r["clock"] == "launches" and r["clock_margin_us"] == -3


def test_host_bound_of_calls_and_steps():
    spans, events = spans_and_events()
    # root 100 us less the wait's 65 us, the second call alone outside
    assert abs(program_spans.host_bound_ms(spans, ("serve.deform",), [True, False]) - 0.035) \
        < 1e-12
    assert program_spans.host_bound_ms(spans, ("serve.deform",), [True]) is None
    assert program_spans.host_bound_ms(spans, ("serve.deform",), [True, True]) is None
    steps = call_spans(10, 0, 0, root="train.step") + call_spans(150, 10, 1, root="train.step")
    r = program_spans.read_slice(events, slice_of(), steps, OFFSET)
    assert abs(r["host_bound_train_ms"] - 45e-3) < 1e-12  # the steps' idle outside replays


def test_mixed_cell_reads_the_program_tracer(tmp_path):
    root = tiny.checkout(tmp_path)
    traced = tiny.run(root, "arbitrary-serve-mixed-q", trace=True, seconds=10.0)
    assert traced["correct"], traced["checks"]
    metrics = traced["metrics"]
    assert metrics["padded_rows_pct.serve"]["value"] > 0
    assert metrics["host_bound_ms.serve"]["value"] > 0
    plain = tiny.run(root, "arbitrary-serve-mixed-q")
    assert set(plain["metrics"]) == {"query_points_per_s", "latency_ms_p95", "peak_reserved_gib",
                                     "setup_s"}


def test_mixed_cell_faults_are_caught(tmp_path):
    root = tiny.checkout(tmp_path)
    for fault in ("answer", "answer_alternate"):
        result = tiny.run(root, "arbitrary-serve-mixed-q", seed=9, fault=fault)
        assert result["correct"] is False, result["checks"]
