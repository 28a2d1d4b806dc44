"""K2's least time for a step's attention backwards (``counts``: the
products at the 3xTF32 tensor-core rate, the rest at the float32 rate, or
the bytes) over K2's device time per step in the whole slice."""


def read(o):
    if o.slice is None or not o.slice.group_s.get("K2"):
        return None
    return 100.0 * o.work["k2_least_ms"] / (1e3 * o.slice.group_s["K2"] / o.slice.requests)
