"""K1's least time for a request's attention calls (``counts``: the
products at the 3xTF32 tensor-core rate, the rest at the float32 rate, or
the bytes) over K1's device time per request in the whole slice."""


def read(o):
    if o.slice is None or not o.slice.group_s.get("K1"):
        return None
    return 100.0 * o.work["k1_least_ms"] / (1e3 * o.slice.group_s["K1"] / o.slice.requests)
