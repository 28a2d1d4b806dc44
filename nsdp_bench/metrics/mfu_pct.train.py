"""The model's matrix-product operations of the train steps taken outside
the profiled slices (``counts``, on the reference: the valid rows only),
per second of those steps, over the card's rate for float32-accurate
products (3xTF32 on the tensor cores, 165 TFLOP/s)."""

from nsdp_bench.counts import PEAK_3XTF32_FLOPS


def read(o):
    if not o.rest_seconds or not o.work.get("flops"):
        return None
    return 100.0 * o.work["flops"] * o.rest_requests / o.rest_seconds / PEAK_3XTF32_FLOPS
