"""Profiling hooks (the port's counterpart of ``nsdp_tpu/utils/profiling.py``).

``trace_steps`` wraps a window of training steps in ``torch.profiler``
(host and CUDA activity) and writes a Chrome/Perfetto trace file;
``StepTimer`` feeds wall-clock steps/s into the stats logger.
"""

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_steps(log_dir: Optional[str]) -> Iterator[None]:
    """Profile everything inside the context into
    ``<log_dir>/trace_<pid>_<time>.json`` (a no-op when ``log_dir`` is None
    or empty).  CUDA activity is recorded where a card is visible."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
