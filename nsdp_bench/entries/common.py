"""The base of every cell (``entries/<entry>.py``, named by a traffic
file's ``entry``)."""

import gc
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from nsdp_bench import harness


class Cell:
    """One cell's program and traffic.  ``setup(state)`` builds the program
    on the seeded weights and warms every shape the traffic uses;
    ``unit(i)`` runs unit i of the window; ``e2e`` gives the end-to-end
    metrics; ``release`` frees the program; ``work`` counts a unit's
    operations; ``readings`` compares with the reference.

    ``calls`` holds each user request's (host seconds, whether it ran in a
    profiled slice, its kind); ``fault`` names a fault planted in the timed
    path (the checks' own tests), or is None."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, spans: harness.Spans,
                 fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.spans, self.fault = spans, fault
        self.calls: List[Tuple[float, bool, object]] = []
        self.stale = Stale()
        self.programs = None
        self.clock = time.perf_counter

    def make_programs(self, graphs_list) -> harness.Programs:
        return harness.Programs(graphs_list, harness.kernel_groups())

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flush(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def failed(self) -> int:
        return 0

    def work(self) -> Dict[str, float]:
        return {}

    def counters(self) -> Dict[str, float]:
        return {}

    @staticmethod
    def log(msg: str):
        print(msg, file=sys.stderr, flush=True)


FLOOR = 1e-7  # float32's rounding: the least error a float32 computation is held to


def float64(ref):
    """The reference ``ref`` on a float64 copy of its weights."""
    return type(ref)(ref.cfg, {k: v.double() if v.is_floating_point() else v.clone()
                               for k, v in ref.p.items()})


def p95_ms(seconds: List[float]) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, 95))


def rel_l2(got, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.detach().double().cpu()
    got = torch.as_tensor(np.asarray(got)).double()
    return float((got - want).norm() / want.norm())


class Stale:
    """The fault 'an answer altered where it is produced', as a static
    output buffer read one call late gives it: each call returns the
    previous call's answer, cut or padded to its own rows."""

    def __init__(self):
        self.last = None

    def __call__(self, out: np.ndarray) -> np.ndarray:
        last, self.last = self.last, np.array(out, copy=True)
        if last is None:
            return out
        rows = np.resize(last, (len(out),) + last.shape[1:])
        return rows.astype(out.dtype)
