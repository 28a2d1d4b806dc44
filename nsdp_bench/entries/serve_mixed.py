"""Dense evaluation at mixed query counts: ``serve.py``'s cell over a pool
whose query counts fall into several of the service's buckets.

Set-up runs one request of each bucket the pool uses (``serve.py`` warms
only the first request's), so every program is captured before the
window.  In a traced run the program's tracer
(``nsdp_tpu_torch.utils.profiling``) is on from the first profiled slice
to the end of the window; :meth:`Cell.counters` then gives the program's
counts over that part (``serve.rows_valid``, ``serve.rows_padded``) and
``host_bound_ms``, the mean over its calls outside the slices of the
``serve.deform`` span less its ``serve.wait`` (``program_spans``).  A run
with ``--trace 0`` never turns the tracer on, and a program without the
tracer gives no counters.  Correctness as in ``serve.py``.
"""

from typing import Dict

from nsdp_bench import program_spans
from nsdp_bench.entries import serve


class Cell(serve.Cell):
    def setup(self, state):
        super().setup(state)
        warmed = {self.svc._bucket(len(self.pool[0]["points"]))}
        for r in self.pool:
            bucket = self.svc._bucket(len(r["points"]))
            if bucket not in warmed:
                warmed.add(bucket)
                self.programs.call(lambda: self.svc.deform(r["points"], r["inputs"]))
        self.tracer = program_spans.tracer()
        self.in_slice = None  # each traced call: whether it ran in a profiled slice
        self.read = None

    def unit(self, i: int) -> int:
        if self.in_slice is None and self.spans.on and self.tracer is not None:
            self.in_slice = []
            self.tracer.start_tracing()
        n = super().unit(i)
        if self.in_slice is not None:
            self.in_slice.append(self.spans.on)
        return n

    def counters(self) -> Dict[str, float]:
        if self.read is None:
            self.read = {}
            if self.in_slice is not None:
                self.tracer.stop_tracing()
                spans, counts = self.tracer.drain()
                self.read = {k: float(v) for k, v in self.tracer.totals(counts).items()}
                ms = program_spans.host_bound_ms(spans, ("serve.deform",), self.in_slice)
                if ms is not None:
                    self.read["host_bound_ms"] = ms
        return self.read

    def release(self):
        if self.in_slice is not None:
            self.tracer.stop_tracing()
        super().release()
