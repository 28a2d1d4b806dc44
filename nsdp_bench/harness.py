"""What every cell shares: the measured window, the profiled slices inside
a traced one, the benchmark's host spans, and the program's launch
counters read around its captures.

A cell (``entries/<entry>.py``) runs units: a request, a session or a
train step.  :func:`window` runs them back to back for ``seconds`` (a
closed loop: one client) and records each unit's host wall time.  With
``--trace 1``, units ``[a, a + n)`` after the first ``TRACE_AT`` share of
the window, and again after ``2 * TRACE_AT`` as a spare, run under
``torch.profiler`` recording the card's activity only (recording every
host operation too would stretch the slice by a millisecond or more a
request), while the benchmark records its own host spans around each call
into the program; the card is synchronised at each slice's ends.  Each
slice's trace is written out as it closes.  Units inside a slice are left
out of every wall-clock figure of the rest of the window.
"""

import contextlib
import importlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"
TRACE_AT = 0.3  # share of the window before the first profiled slice


def kernel_groups() -> Dict[str, Dict]:
    """{group: {"counter", "marker", "kernels"}} from ``kernels/*.json``;
    files naming the same group are merged."""
    groups: Dict[str, Dict] = {}
    for path in sorted(KERNELS_DIR.glob("*.json")):
        spec = json.loads(path.read_text())
        g = groups.setdefault(spec["group"], {"counter": [], "marker": set(), "kernels": set()})
        g["counter"].append(spec["counter"])
        g["marker"] |= set(spec["marker"])
        g["kernels"] |= set(spec["kernels"])
    return groups


def read_counter(path: str) -> int:
    """``module:attr.attr`` of the program, e.g. a wrapper's ``.launches``."""
    module, attrs = path.split(":")
    obj = importlib.import_module(module)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


def counters(groups: Dict[str, Dict]) -> Dict[str, int]:
    return {g: sum(read_counter(c) for c in spec["counter"]) for g, spec in groups.items()}


class Programs:
    """The program's captured programs (``graphs.Graphs.programs`` of each
    given ``Graphs``) and each one's launches per replay by kernel group.

    A replay moves no launch counter; a capture does, once for each time
    the function ran while its program was made: twice where the program
    runs one throw-away eager call before capturing (``eager_calls == 0``,
    ``graphs.py``), else once.  :meth:`call` reads the counters around a
    call that captured exactly one program."""

    def __init__(self, graphs_list, groups: Dict[str, Dict]):
        self.graphs = [g for g in graphs_list if g is not None]
        self.groups = groups
        self.per_replay: Dict[int, Dict[str, int]] = {}

    def all(self):
        return [p for g in self.graphs for p in g.programs.values()]

    def calls(self) -> Dict[int, int]:
        return {id(p): p.calls for p in self.all()}

    def call(self, fn: Callable):
        captured_before = {id(p) for p in self.all() if p.graph is not None}
        before = counters(self.groups)
        out = fn()
        after = counters(self.groups)
        new = [p for p in self.all() if p.graph is not None and id(p) not in captured_before]
        if len(new) == 1:
            runs = 2 if new[0].eager_calls == 0 else 1
            self.per_replay[id(new[0])] = {g: (after[g] - before[g]) // runs for g in after}
        return out

    def shape_of(self, moved: Dict[int, int]):
        """The first input's shape of the one program whose calls moved
        since ``moved`` (None if none or several)."""
        hits = [p for p in self.all() if p.calls != moved.get(id(p), 0)]
        if len(hits) != 1 or hits[0].inputs is None:
            return None
        return tuple(hits[0].inputs[0].shape)


@dataclass
class Unit:
    """One unit of work: its host wall time, the requests it holds, and
    whether it ran inside a profiled slice."""
    seconds: float
    requests: int = 1
    traced: bool = False


@dataclass
class Slice:
    n: int
    requests: int = 0
    start: float = 0.0  # host clock (time.perf_counter), after the first synchronisation
    end: float = 0.0  # host clock, after the last
    trace: str = ""  # the Chrome trace's path
    spans: List = field(default_factory=list)  # (name, start, end) on the host clock
    replays: Dict[int, int] = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    seconds: float
    units: List[Unit]
    slices: List[Slice]


class Spans:
    """The benchmark's host spans, ``(name, start, end)`` on the host
    clock, recorded only while a slice is profiled."""

    def __init__(self):
        self.on = False
        self.log: List = []

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def _span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.log.append((name, t0, time.perf_counter()))


def window(seconds: float, unit: Callable[[int], int], trace: bool, trace_units: int,
           spans: Spans, programs: Optional[Programs], sync: Callable[[], None]) -> Window:
    """Run ``unit(i)`` (-> the requests it served) for ``seconds``; the
    loop starts no unit after the deadline and waits for the last one.
    Python's cyclic garbage collector is off inside the window (a pause of
    its would land in some request's latency)."""
    import gc

    gc.collect()
    gc.disable()
    try:
        return _window(seconds, unit, trace, trace_units, spans, programs, sync)
    finally:
        gc.enable()


def _window(seconds, unit, trace, trace_units, spans, programs, sync) -> Window:
    from torch.profiler import ProfilerActivity, profile

    starts = [TRACE_AT * seconds, 2 * TRACE_AT * seconds] if trace else []
    units: List[Unit] = []
    slices: List[Slice] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        if starts and time.perf_counter() - t0 >= starts[0]:
            starts.pop(0)
            sync()
            s = Slice(n=trace_units)
            before = programs.calls() if programs else {}
            prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                       else ProfilerActivity.CPU])
            prof.__enter__()
            spans.log, spans.on = [], True
            s.start = time.perf_counter()
            for _ in range(trace_units):
                u0 = time.perf_counter()
                n = unit(i)
                units.append(Unit(time.perf_counter() - u0, n, traced=True))
                s.requests += n
                i += 1
            sync()
            s.end = time.perf_counter()
            spans.on = False
            prof.__exit__(None, None, None)
            s.spans = list(spans.log)
            after = programs.calls() if programs else {}
            s.replays = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
            fd, s.trace = tempfile.mkstemp(suffix=".json", prefix="nsdp_bench_trace_")
            os.close(fd)
            prof.export_chrome_trace(s.trace)
            slices.append(s)
            continue
        u0 = time.perf_counter()
        n = unit(i)
        units.append(Unit(time.perf_counter() - u0, n))
        i += 1
    sync()
    return Window(time.perf_counter() - t0, units, slices)
