"""Host time of a session open or drag: the mean wall time, outside the profiled
slices, of calls of the kinds the whole slice holds (a kind: the entry and
its padded size), less the card's busy time per call inside the slice.
The profiler's own cost stays out of the wall time."""


def read(o):
    if o.slice is None or o.matched_latency_s is None:
        return None
    return 1e3 * (o.matched_latency_s - o.slice.busy_s / o.slice.requests)
