"""Profiling hooks (the port's counterpart of ``nsdp_tpu/utils/profiling.py``).

``trace_steps`` wraps a window of training steps in ``torch.profiler``
(host and CUDA activity) and writes a Chrome/Perfetto trace file, with the
program's own spans in it; ``StepTimer`` feeds wall-clock steps/s into the
stats logger.

The in-process tracer.  The program marks its layer boundaries with
``with span(name):`` and its counts with ``count(name, n)``.  Both are off
by default: a span site then tests one module-level flag and returns a
shared no-op context, reading no clock and allocating nothing.
``start_tracing()`` turns them on, ``stop_tracing()`` off, and ``drain()``
hands back (and forgets) what was recorded: each span's name, start and
end (``time.perf_counter_ns``, the host's monotonic clock), its parent
span, the request id that every span of one top-level call shares, and a
detail (a captured program's name, a train step's model type and
compute dtype); each count with the request open when it was made.
Recording is host work alone: it adds no CUDA call, no synchronisation
and no copy.  The spans (``nsdp_tpu_torch``):

* ``serve.deform``, ``serve.open``, ``serve.drag`` -- a
  ``DeformationService.deform``, ``edit_session``, ``EditSession.drag``
  call (each a root: a new request id); under each ``serve.pad`` (the
  bucket, the padding, the split into shares) and ``serve.fetch`` (the
  join, the slice and the host copy; in an open, the clone of the
  canonical pose), in whose copy ``serve.wait`` (the host blocked until
  the card has finished the call's work and the copy); counts
  ``serve.rows_valid`` and ``serve.rows_padded`` (the query rows asked
  for, the rows that ran);
* ``graphs.stage``, ``graphs.replay``, ``graphs.eager``,
  ``graphs.capture`` -- a captured program's arguments copied into its
  static buffers, its graph's replay, an eager call, a capture, each with
  the program's name as its detail;
* ``train.step`` (a root, with the model type as its detail: ``forward``,
  ``backward`` or ``arbitrary``, then the compute dtype where the model
  has one, as in ``arbitrary bfloat16``), ``train.inputs``,
  ``train.optimizer``, ``train.loss`` -- a ``train_step`` call, its batch's tensors, the
  learning rate set and ``optimizer.step()``, the loss read or copied.
"""

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

_on = False  # the one flag a span or count site tests


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]  # the enclosing span's id; None for a root
    request: int  # shared by every span of one top-level call
    detail: Optional[str]


class Count(NamedTuple):
    name: str
    n: int
    request: Optional[int]  # the request open when it was counted, if any
    at_ns: int


_spans: List[Span] = []
_counts: List[Count] = []
_ids = itertools.count()
_requests = itertools.count()
_local = threading.local()  # each thread's stack of open spans


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    """A span being recorded: it opens under the innermost span open on
    its thread, or as a root with a new request id."""

    __slots__ = ("name", "detail", "id", "parent", "request", "start")

    def __init__(self, name: str, detail: Optional[str]):
        self.name, self.detail = name, detail

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if top is None else top.id
        self.request = next(_requests) if top is None else top.request
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        _spans.append(Span(self.id, self.name, self.start, end, self.parent, self.request,
                           self.detail))
        return False


def span(name: str, detail: Optional[str] = None):
    """A context that records a span named ``name`` while the tracer is on
    (module docstring), and does nothing while it is off."""
    if not _on:
        return _NOOP
    return _Open(name, detail)


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` while the tracer is on."""
    if _on:
        stack = _stack()
        _counts.append(Count(name, int(n), stack[-1].request if stack else None,
                             time.perf_counter_ns()))


def start_tracing() -> None:
    """Turn the tracer on; what it records stays until :func:`drain`."""
    global _on
    _on = True


def stop_tracing() -> None:
    global _on
    _on = False


def tracing() -> bool:
    return _on


def drain() -> Tuple[List[Span], List[Count]]:
    """-> (the spans, the counts) recorded since the last drain, in the
    order they closed; both are then forgotten."""
    global _spans, _counts
    spans, counts, _spans, _counts = _spans, _counts, [], []
    return spans, counts


def totals(counts: List[Count]) -> Dict[str, int]:
    """Each count's sum."""
    out: Dict[str, int] = {}
    for c in counts:
        out[c.name] = out.get(c.name, 0) + c.n
    return out


def trace_events(spans: List[Span], counts: List[Count], offset_us: float,
                 pid: int) -> List[Dict]:
    """Chrome trace events of the tracer's records, on a clock ``offset_us``
    ahead of the host's: a complete ("X") event per span on thread 0 of
    ``pid``, named "nsdp_tpu_torch spans", and a counter ("C") event per
    count with its running total."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "nsdp_tpu_torch spans"}}]
    for s in spans:
        out.append({"ph": "X", "cat": "nsdp", "name": s.name, "pid": pid, "tid": 0,
                    "ts": s.start_ns / 1e3 + offset_us, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "request": s.request,
                             "detail": s.detail}})
    running: Dict[str, int] = {}
    for c in sorted(counts, key=lambda c: c.at_ns):
        running[c.name] = running.get(c.name, 0) + c.n
        out.append({"ph": "C", "cat": "nsdp", "name": c.name, "pid": pid, "tid": 0,
                    "ts": c.at_ns / 1e3 + offset_us, "args": {c.name: running[c.name]}})
    return out


def _clock_anchor() -> Tuple[str, int]:
    """A profiler record named for this call, opened right after a reading
    of the host clock: -> (its name, that reading in ns).  A first record
    of the same name's ``.warm`` takes the profiler's set-up cost."""
    name = f"nsdp.clock.{time.perf_counter_ns()}"
    with torch.profiler.record_function(name + ".warm"):
        pass
    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(name):
        pass
    return name, t0


@contextlib.contextmanager
def trace_steps(log_dir: Optional[str]) -> Iterator[None]:
    """Profile everything inside the context into
    ``<log_dir>/trace_<pid>_<time>.json`` (a no-op when ``log_dir`` is None
    or empty).  CUDA activity is recorded where a card is visible.  The
    tracer is on inside the context and drained at its end, into the same
    trace, on its clock (the host clock read before a profiler record of
    the window's start)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        anchor, host_ns = _clock_anchor()
        start_tracing()
        try:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            stop_tracing()
    spans, counts = drain()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    ts = next(e["ts"] for e in trace["traceEvents"] if e.get("name") == anchor)
    trace["traceEvents"] += trace_events(spans, counts, ts - host_ns / 1e3, os.getpid())
    with open(path, "w") as f:
        json.dump(trace, f)


class StepTimer:
    """Steps/s and seconds/step over a sliding window of ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0

    @property
    def sec_per_step(self) -> float:
        sps = self.steps_per_sec
        return 1.0 / sps if sps > 0 else 0.0
