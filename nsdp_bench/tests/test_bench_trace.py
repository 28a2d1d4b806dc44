"""The profiled slice read back, on synthetic traces: a whole slice gives
busy time, device time by kernel group, library time and the card's idle
time named by the benchmark's host spans (put on the trace's clock by the
slice's closing synchronisation); a slice from which a replay's kernel
record was lost gives no per-layer number (not a low one)."""

import json
from types import SimpleNamespace

from nsdp_bench import harness, trace
from nsdp_bench.run import HERE, load_module, observation

OFFSET = 5_000_000.0  # trace clock minus host clock, us


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"void (anonymous namespace)::{name}<4>(Params)",
            "ts": ts + OFFSET, "dur": dur}


def replay_events(t0):
    """One replay of a program with 2 K1 launches and a cuBLAS product:
    70 us busy, 30 us of idle card inside its 100 us call span."""
    return [kernel("knn_kernel", t0 + 10, 10), kernel("attn_bcast_kernel", t0 + 20, 20),
            kernel("knn_kernel", t0 + 40, 10), kernel("attn_kernel", t0 + 50, 20),
            {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32_tn", "ts": t0 + 80 + OFFSET,
             "dur": 10}]


def slice_of(tmp_path, events, replays=2):
    """A slice over host time [0, 250] us: the calls' spans at 10 and 130."""
    s = harness.Slice(n=replays, requests=replays, start=0.0, end=250e-6)
    s.spans = [("deform", 10e-6, 110e-6), ("deform", 130e-6, 230e-6)][:replays]
    sync = {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 240 + OFFSET,
            "dur": 10}
    s.trace = str(tmp_path / f"trace{len(list(tmp_path.iterdir()))}.json")
    with open(s.trace, "w") as f:
        json.dump({"traceEvents": events + [sync]}, f)
    s.replays = {7: replays}
    return s


GROUPS = harness.kernel_groups()
PER_REPLAY = {7: {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "gather": 0}}


def test_whole_slice(tmp_path):
    events = replay_events(10) + replay_events(130)
    r = trace.read_slice(slice_of(tmp_path, events), PER_REPLAY, GROUPS)
    assert r.whole, r.why
    assert abs(r.busy_s - 2 * 70e-6) < 1e-12
    assert abs(r.group_s["K1"] - 2 * 60e-6) < 1e-12 and abs(r.library_s - 2 * 10e-6) < 1e-12
    idle = dict(r.idle_gaps)
    assert abs(idle["deform"] - 2 * 30e-6) < 1e-12  # inside the call spans
    assert abs(idle["harness"] - (250 - 2 * 100) * 1e-6) < 1e-12
    assert abs(dict(r.device_ops)["knn_kernel"] - 4 * 10e-6) < 1e-12
    assert not list(tmp_path.iterdir())  # the trace is removed once read


def test_lost_records_give_no_numbers(tmp_path):
    events = replay_events(10) + replay_events(130)
    lost = [e for e in events if not (e["ts"] == 130 + 40 + OFFSET and "knn_kernel" in e["name"])]
    assert len(lost) == len(events) - 1
    r = trace.read_slice(slice_of(tmp_path, lost), PER_REPLAY, GROUPS)
    assert not r.whole and "K1" in r.why
    win = harness.Window(1.0, [harness.Unit(0.02, 1), harness.Unit(0.02, 1, traced=True)], [])
    entry = SimpleNamespace(calls=[(0.02, False, "deform"), (0.02, True, "deform")],
                            counters=lambda: {})
    obs = observation(win, entry, r, {"k1_least_ms": 0.001, "flops": 1e9})
    for name in ("k1_roofline.serve", "library_ms.serve", "idle_pct.serve", "host_ms.serve"):
        assert load_module(HERE / "metrics" / f"{name}.py", name).read(obs) is None
    whole = trace.read_slice(slice_of(tmp_path, events), PER_REPLAY, GROUPS)
    obs = observation(win, entry, whole, {"k1_least_ms": 0.001, "flops": 1e9})
    k1 = load_module(HERE / "metrics" / "k1_roofline.serve.py", "k1").read(obs)
    assert abs(k1 - 100 * 0.001 / (1e3 * 120e-6 / 2)) < 1e-9


def test_records_without_duration_are_not_whole(tmp_path):
    events = replay_events(10) + replay_events(130)
    for e in events:
        e["dur"] = 0.0
    assert not trace.read_slice(slice_of(tmp_path, events), PER_REPLAY, GROUPS).whole


def test_unknown_program_is_not_whole(tmp_path):
    r = trace.read_slice(slice_of(tmp_path, replay_events(10), replays=1), {}, GROUPS)
    assert not r.whole


def test_a_second_slice_stands_in(tmp_path):
    events = replay_events(10) + replay_events(130)
    slices = [slice_of(tmp_path, events[:-2]), slice_of(tmp_path, events)]
    assert trace.first_whole(slices, PER_REPLAY, GROUPS).whole
    trace.remove_traces(slices)
    assert not list(tmp_path.iterdir())
