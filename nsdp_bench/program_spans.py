"""The program's own spans (``nsdp_tpu_torch.utils.profiling``) read on
their own and beside a profiled slice's device trace.

On their own: :func:`host_bound_ms`, a call's root span less its
``serve.wait`` -- in a closed loop with one client, the time the card has
none of the call's work.

Beside a slice's trace (:func:`read_slice`): the spans, stamped on the
host clock, are put on the trace's clock by the offset of the slice's
closing synchronisation (``trace.clock_offset_us``).  A replay's device
window runs from the first to the last device operation that carries the
correlation id of one ``cudaGraphLaunch`` runtime record.  Each idle piece
of the slice is named ``replay:<program>`` inside a replay's window, else
after the innermost program span open at the time, else after the
innermost benchmark span, else ``harness``; the names partition the
slice's idle time.  The clock check: each ``graphs.replay`` span, taken in
order with the launches, must contain its ``cudaGraphLaunch`` record; the
worst margin is reported (negative: not contained).  Where the closing
synchronisation's offset fails it, the offset is fitted to the launches
instead: the middle of the offsets that put every launch inside its span,
whose margin is then half that range's width.  Graph numbers are
given only where the launches found equal the replays that the programs'
``calls`` counted in the slice.

``python -m nsdp_bench.program_spans --workload <cell> --seed <n>
--seconds <s>`` runs a cell's program on the card in three windows --
tracer off, tracer on for the whole window with profiled slices as a
``--trace 1`` run makes them, tracer off -- and prints one JSON line: the
per-slice readings above, the host-bound times, the padded rows, the
calls' wall time outside the slices with the tracer on and off, and a
span site's cost off and on.  The reference's comparison is not run.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAIT = "serve.wait"


def tracer():
    """The program's profiling module if it has the tracer, else None (a
    program from before it)."""
    from nsdp_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "start_tracing") else None


def roots(spans, names: Sequence[str]) -> List:
    """The root spans named one of ``names``, in order of start."""
    return sorted((s for s in spans if s.parent is None and s.name in names),
                  key=lambda s: s.start_ns)


def waits_ns(spans) -> Counter:
    """Request id -> the time its ``serve.wait`` spans cover (ns)."""
    out: Counter = Counter()
    for s in spans:
        if s.name == WAIT:
            out[s.request] += s.end_ns - s.start_ns
    return out


def host_bound_ms(spans, names: Sequence[str], in_slice: Sequence[bool]) -> Optional[float]:
    """Mean over the calls outside the profiled slices of a root span named
    one of ``names`` less its ``serve.wait``, in ms; ``in_slice[i]`` says
    whether the i-th such root (in order of start) ran in a slice.  None if
    the roots are not one per call or none ran outside."""
    calls = roots(spans, names)
    if len(calls) != len(in_slice):
        return None
    waited = waits_ns(spans)
    bound = [(r.end_ns - r.start_ns - waited[r.request]) / 1e6
             for r, inside in zip(calls, in_slice) if not inside]
    return statistics.fmean(bound) if bound else None


def graph_launches(events: List[Dict]) -> List[Tuple[Dict, float, float]]:
    """Each ``cudaGraphLaunch`` record with device work, in order, and its
    replay's device window: (record, first start, last end) in us."""
    ops: Dict[int, List[Dict]] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "correlation" in e.get("args", {}):
            ops.setdefault(e["args"]["correlation"], []).append(e)
    out = []
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaGraphLaunch":
            mine = ops.get(e.get("args", {}).get("correlation"))
            if mine:
                out.append((e, min(o["ts"] for o in mine), max(o["ts"] + o["dur"] for o in mine)))
    return sorted(out, key=lambda x: x[0]["ts"])


def clock_margin_us(replays: List, launches: List) -> Optional[float]:
    """The least margin by which a ``graphs.replay`` span (on the trace's
    clock, ``(start, end)``) contains its ``cudaGraphLaunch`` record, the
    two taken in order; None if their numbers differ."""
    if len(replays) != len(launches) or not replays:
        return None
    return min(min(e["ts"] - a, b - (e["ts"] + e["dur"]))
               for (a, b), (e, _, _) in zip(replays, launches))


def launch_offset_us(replays: List, launches: List) -> Optional[Tuple[float, float]]:
    """(offset, margin): the trace-minus-host offset (us) that puts each
    ``graphs.replay`` span (on the host clock, ``(start, end)`` in us)
    around its ``cudaGraphLaunch`` record, the two taken in order, with
    the largest least margin, and that margin (negative: no one offset
    does); None if their numbers differ."""
    if len(replays) != len(launches) or not replays:
        return None
    lo = max(e["ts"] + e["dur"] - b for (_, b), (e, _, _) in zip(replays, launches))
    hi = min(e["ts"] - a for (a, _), (e, _, _) in zip(replays, launches))
    return (lo + hi) / 2, (hi - lo) / 2


def _innermost(spans: List[Tuple], t: float):
    """The shortest (name, start, end, ...) of ``spans`` containing t."""
    best = None
    for s in spans:
        if s[1] <= t <= s[2] and (best is None or s[2] - s[1] < best[2] - best[1]):
            best = s
    return best


def idle_pieces(device: List[Tuple[float, float]], lo: float, hi: float, windows: List[Tuple],
                program: List[Tuple], bench: List[Tuple]) -> List[Tuple[float, str, str]]:
    """The card's idle time in [lo, hi] (us) cut at every span and window
    edge: (seconds, name, kind) per piece; kind is ``replay``,
    ``program:<root>`` (its innermost program span's root), ``bench`` or
    ``harness``.  ``windows``: (program name, start, end); ``program``:
    (name, start, end, root name); ``bench``: (name, start, end)."""
    from nsdp_bench.trace import gaps

    edges = sorted({t for s in (*windows, *program, *bench) for t in s[1:3]})
    out = []
    for a, b in gaps(device, lo, hi):
        cuts = [a] + [t for t in edges if a < t < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            w = next((w for w in windows if w[1] <= mid <= w[2]), None)
            if w is not None:
                out.append(((y - x) / 1e6, f"replay:{w[0]}", "replay"))
                continue
            p = _innermost(program, mid)
            if p is not None:
                out.append(((y - x) / 1e6, p[0], f"program:{p[3]}"))
                continue
            h = _innermost(bench, mid)
            out.append(((y - x) / 1e6, h[0], "bench") if h else ((y - x) / 1e6, "harness",
                                                               "harness"))
    return out


def read_slice(events: List[Dict], s, spans, sync_offset_us: float) -> Dict:
    """One profiled slice (``harness.Slice``) beside the program's ``spans``
    recorded over it; per unit of the slice where so named.  The clock:
    the closing synchronisation's offset where it passes the check, else
    the offset fitted to the launches (:func:`launch_offset_us`)."""
    from nsdp_bench.trace import union_us

    lo_ns, hi_ns = s.start * 1e9, s.end * 1e9
    mine = [p for p in spans if lo_ns <= p.start_ns and p.end_ns <= hi_ns]
    ids = {p.id: p for p in mine}

    def root(p):
        while p.parent is not None and p.parent in ids:
            p = ids[p.parent]
        return p

    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    launches = graph_launches(events)
    replays = sorted((p for p in mine if p.name == "graphs.replay"), key=lambda p: p.start_ns)
    counted = sum(s.replays.values())
    host = [(r.start_ns / 1e3, r.end_ns / 1e3) for r in replays]
    sync_margin = clock_margin_us([(a + sync_offset_us, b + sync_offset_us) for a, b in host],
                                  launches)
    fitted = launch_offset_us(host, launches)
    offset_us, clock = sync_offset_us, "sync"
    if fitted is not None and sync_margin < 0:
        offset_us, clock = fitted[0], "launches"
    on = lambda ns: ns / 1e3 + offset_us
    labels = ([r.detail for r in replays] if len(replays) == len(launches)
              else ["?"] * len(launches))
    windows = [(label, a, b) for label, (_, a, b) in zip(labels, launches)]
    program = [(p.name, on(p.start_ns), on(p.end_ns), root(p).name) for p in mine]
    bench = [(n, a * 1e6 + offset_us, b * 1e6 + offset_us) for n, a, b in s.spans]
    pieces = idle_pieces(device, on(lo_ns), on(hi_ns), windows, program, bench)
    by_kind: Counter = Counter()
    by_name: Counter = Counter()
    for sec, name, kind in pieces:
        by_kind[kind.split(":")[0]] += sec
        by_name[name] += sec
    steps = [p for p in mine if p.parent is None and p.name == "train.step"]
    train_idle = sum(sec for sec, _, kind in pieces if kind == "program:train.step")
    whole = len(launches) == counted and counted > 0
    per = lambda sec: 1e3 * sec / s.n
    return {
        "units": s.n, "wall_ms": 1e3 * (s.end - s.start),
        "busy_ms": union_us(device) / 1e3, "idle_ms": 1e3 * sum(p[0] for p in pieces),
        "replays_found": len(launches), "replays_counted": counted,
        "clock": clock, "clock_margin_sync_us": sync_margin,
        "clock_margin_us": clock_margin_us([(a + offset_us, b + offset_us) for a, b in host],
                                           launches),
        "graph_idle_ms": per(by_kind["replay"]) if whole else None,
        "program_idle_ms": per(by_kind["program"]), "bench_idle_ms": per(by_kind["bench"]),
        "harness_idle_ms": per(by_kind["harness"]),
        "replay_window_ms": per(sum(b - a for _, a, b in launches) / 1e6) if whole else None,
        "host_bound_train_ms": 1e3 * train_idle / len(steps) if steps and whole else None,
        "idle_by_name_ms": {k: per(v) for k, v in by_name.most_common(12)},
    }


def span_site_ns(n: int = 200_000) -> Dict[str, float]:
    """A span site's cost on this host, off and on (ns per ``with``)."""
    profiling = tracer()
    span = profiling.span
    out = {}
    for label, on in (("off", False), ("on", True)):
        (profiling.start_tracing if on else profiling.stop_tracing)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("probe"):
                pass
        out[label] = (time.perf_counter_ns() - t0) / n
        profiling.stop_tracing()
        profiling.drain()
    return out


def probe(cell: str, seed: int, seconds: float, device: str = "cuda") -> Dict:
    """The three windows of the module docstring on the card -> the line
    (``device="cpu"`` rehearses them on the program's plain path)."""
    import torch

    from nsdp_bench import harness, run
    from nsdp_bench import trace as tracing
    from nsdp_bench.weights import calibrated_state

    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = run.find(spec, cell)
    torch.set_num_threads(4)
    state = calibrated_state(cfg["model"], seed, device)
    spans = harness.Spans()
    module = run.load_module(run.HERE / "entries" / f"{traffic['entry']}.py",
                             f"nsdp_bench.entries.{traffic['entry']}")
    entry = module.Cell(cfg, traffic, seed, device, spans, None)
    entry.setup(state)
    del state
    profiling = tracer()
    groups = harness.kernel_groups()
    names = {"serve": ("serve.deform",), "serve_mixed": ("serve.deform",),
             "drag": ("serve.open", "serve.drag"), "train": ("train.step",)}[traffic["entry"]]
    out: Dict = {"cell": cell, "seed": seed, "windows": [],
                 "device": torch.cuda.get_device_name(0) if device == "cuda" else device,
                 "power_limit_w": run.power_limit() if device == "cuda" else None}
    for on in (False, True, False):
        first = len(entry.calls)
        profiling.drain()
        if on:
            profiling.start_tracing()
        win = harness.window(seconds, entry.unit, on, traffic.get("trace_units", 1), spans,
                             entry.programs, entry.sync)
        profiling.stop_tracing()
        recorded, counts = profiling.drain()
        calls = entry.calls[first:]
        rest = [c[0] for c in calls if not c[1]]
        w = {"tracer": on, "calls": len(calls),
             "call_ms_outside_slices": 1e3 * statistics.fmean(rest) if rest else None,
             "by_kind_ms": {str(k): 1e3 * statistics.fmean([c[0] for c in calls
                                                            if not c[1] and c[2] == k])
                            for k in sorted({c[2] for c in calls if not c[1]}, key=str)}}
        if on:
            w["host_bound_ms"] = host_bound_ms(recorded, names, [c[1] for c in calls])
            w["counts"] = profiling.totals(counts)
            w["slices"] = []
            for s in win.slices:
                copy = s.trace + ".copy"
                shutil.copy(s.trace, copy)
                bench = tracing.read_slice(s, entry.programs.per_replay, groups)
                events = tracing.read_events(copy)
                r = read_slice(events, s, recorded, tracing.clock_offset_us(events, s.end))
                r.update(whole=bench.whole, why=bench.why, bench_idle_gaps_ms={
                    n: 1e3 * v / s.n for n, v in bench.idle_gaps})
                in_calls = [p for p in roots(recorded, names)
                            if s.start * 1e9 <= p.start_ns and p.end_ns <= s.end * 1e9]
                waited = waits_ns(recorded)
                r["host_bound_in_slice_ms"] = statistics.fmean(
                    [(p.end_ns - p.start_ns - waited[p.request]) / 1e6 for p in in_calls]
                ) if in_calls else None
                w["slices"].append(r)
        out["windows"].append(w)
    out["span_site_ns"] = span_site_ns()
    entry.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's program with its spans on, beside the "
                                             "profiled slices' device traces")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from nsdp_bench.run import CACHE

    for name, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[name] = str(CACHE / sub)
    import torch

    if not torch.cuda.is_available():
        print("nsdp_bench.program_spans: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(probe(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
