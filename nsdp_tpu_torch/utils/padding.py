"""Query-axis bucket padding (the port's copy of ``nsdp_tpu.utils.padding``).

The decoder evaluates query points independently, so padding the query axis
is exact: padded rows are evaluated and sliced off.  Serving pads to a small
ladder of sizes so the device sees few distinct shapes.
"""

import math

import numpy as np


def next_bucket(n: int, bucket: int = 4096) -> int:
    """Smallest multiple of ``bucket`` >= n (at least one bucket)."""
    return max(bucket, int(math.ceil(n / bucket)) * bucket)


def pad_queries(points: np.ndarray, bucket: int = 4096):
    """Pad (B, Q, 3) along Q to a bucket size; returns (padded, original_q)."""
    q = points.shape[1]
    target = next_bucket(q, bucket)
    if target == q:
        return points, q
    pad = np.zeros(
        (points.shape[0], target - q, points.shape[2]), dtype=points.dtype
    )
    return np.concatenate([np.asarray(points), pad], axis=1), q
