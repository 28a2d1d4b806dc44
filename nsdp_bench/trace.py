"""A profiled slice read back: the card's busy time, device time by kernel
group, the other kernels (libraries), the card's idle time named by the
benchmark's host span open at the time, and whether the slice is whole.

The host spans are on the host's clock (``time.perf_counter``), the trace
on the profiler's; the two are put on one clock by the slice's closing
synchronisation, which ends both the slice and the trace's last
``cuda*Synchronize`` call.

Whole means: for every kernel group, the trace holds exactly as many of
its marker kernels (one per launch) as the replays in the slice times each
program's launches per replay (``harness.Programs``).  ``torch.profiler``
has lost records of graph replays late in a process; a slice with a
record missing, or one whose programs' launches are not known, gives no
per-layer number.
"""

import json
import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nsdp_bench.harness import Slice

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments (``void (anonymous namespace)::attn_kernel<4>(...)`` ->
    ``attn_kernel``)."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split("::")[-1].replace("void ", "").strip() or "?"


def union_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(spans):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (end - start if end is not None else 0.0)


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    out, at = [], lo
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class SliceReading:
    whole: bool
    why: str
    units: int
    requests: int
    wall_s: float
    busy_s: float
    group_s: Dict[str, float] = field(default_factory=dict)
    library_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def read_events(path: str) -> List[Dict]:
    """The complete ("X") events of a Chrome trace, which is then removed."""
    try:
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)


def remove_traces(slices: List[Slice]) -> None:
    for s in slices:
        if s.trace and os.path.exists(s.trace):
            os.remove(s.trace)


def clock_offset_us(events: List[Dict], end_s: float) -> float:
    """Trace clock minus host clock (us), from the slice's closing
    synchronisation; 0 if the trace holds none."""
    syncs = [e["ts"] + e["dur"] for e in events
             if e.get("cat") == "cuda_runtime" and "Synchronize" in e.get("name", "")]
    return max(syncs) - end_s * 1e6 if syncs else 0.0


def read_slice(s: Slice, per_replay: Dict[int, Dict[str, int]], groups: Dict[str, Dict]
               ) -> SliceReading:
    events = read_events(s.trace)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [(kernel_name(e["name"]), e) for e in device if e.get("cat") == "kernel"]
    busy = union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e6
    r = SliceReading(True, "", s.n, s.requests, s.wall_s, busy)
    member = {k: g for g, spec in groups.items() for k in spec["kernels"]}
    by_name: Counter = Counter()
    for name, e in kernels:
        by_name[name] += e["dur"] / 1e6
        g = member.get(name)
        if g is None:
            r.library_s += e["dur"] / 1e6
        else:
            r.group_s[g] = r.group_s.get(g, 0.0) + e["dur"] / 1e6
    for e in device:
        if e.get("cat") != "kernel":
            by_name[e["cat"]] += e["dur"] / 1e6
    r.device_ops = by_name.most_common(10)
    # whole: each group's markers against the replays' launches
    names = Counter(name for name, _ in kernels)
    for prog, n in s.replays.items():
        if prog not in per_replay:
            r.whole, r.why = False, "a program replayed in the slice whose launches are unknown"
    if r.whole:
        for g, spec in groups.items():
            want = sum(n * per_replay[p].get(g, 0) for p, n in s.replays.items())
            got = sum(names[m] for m in spec["marker"])
            if got != want:
                r.whole = False
                r.why = f"{g}: {got} marker kernels in the trace, {want} launched by the replays"
                break
    if not device or any(e["dur"] <= 0 for _, e in kernels):
        r.whole, r.why = False, "kernel records without a duration, or none"
    # idle card inside the slice, named by the innermost benchmark span
    if device:
        off = clock_offset_us(events, s.end)
        inner = sorted(((n, a * 1e6 + off, b * 1e6 + off) for n, a, b in s.spans),
                       key=lambda x: x[2] - x[1])
        edges = sorted({t for _, a, b in inner for t in (a, b)})
        idle: Counter = Counter()
        for a, b in gaps([(e["ts"], e["ts"] + e["dur"]) for e in device],
                         s.start * 1e6 + off, s.end * 1e6 + off):
            cuts = [a] + [t for t in edges if a < t < b] + [b]
            for x, y in zip(cuts, cuts[1:]):  # each piece lies in one set of spans
                mid = (x + y) / 2
                span = next((n for n, sa, sb in inner if sa <= mid <= sb), "harness")
                idle[span] += (y - x) / 1e6
        r.idle_gaps = idle.most_common(10)
    return r


def first_whole(slices: List[Slice], per_replay, groups) -> Optional[SliceReading]:
    """The reading of the first whole slice, or the last reading (not
    whole) if none is; None without slices."""
    reading = None
    for s in slices:
        reading = read_slice(s, per_replay, groups)
        if reading.whole:
            break
    return reading
