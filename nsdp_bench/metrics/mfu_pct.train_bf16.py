"""The least time of a bfloat16 train step's matrix products over its
measured time, outside the profiled slices: the products that run in
bfloat16 at the card's dense bfloat16 rate (989 TFLOP/s) plus those in
float32 at the rate of float32-accurate products (3xTF32 on the tensor
cores, 165 TFLOP/s), both counted on the rounding reference over the valid
rows (``reference/bf16.py``, ``entries/train_bf16.py``)."""

from nsdp_bench.counts import PEAK_3XTF32_FLOPS

PEAK_BF16_FLOPS = 989e12  # one NVIDIA H100 SXM, dense bfloat16 (data sheet, 700 W)


def read(o):
    if not o.rest_seconds or not o.work.get("flops_bf16"):
        return None
    least_s = o.work["flops_bf16"] / PEAK_BF16_FLOPS + o.work["flops_f32"] / PEAK_3XTF32_FLOPS
    return 100.0 * least_s * o.rest_requests / o.rest_seconds
