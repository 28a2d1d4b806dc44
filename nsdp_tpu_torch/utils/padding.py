"""Static-shape helpers (the port's copy of ``nsdp_tpu.utils.padding``).

The decoder evaluates query points independently, so padding the query axis
is exact: padded rows are evaluated and sliced off.  Serving and the test
entry points pad to a few sizes so the device sees few distinct shapes.
Conditioning point clouds are NOT padded: zero rows would corrupt FPS/kNN
neighbourhoods.
"""

import math

import numpy as np
import torch


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


def pad_batch(batch: dict, target_b: int):
    """Pad every leaf's leading (batch) axis to ``target_b``; return mask.

    Padded rows replicate the last real sample (valid data, so FPS/kNN see
    nothing degenerate) and are excluded from losses via the returned
    ``sample_mask`` (target_b,) float32 — 1 for real rows, 0 for padding.
    Used for no-drop validation (reference evaluates every val sample,
    ``train.py:130-136`` with torch's default ``drop_last=False``).
    """
    sizes = {np.asarray(v).shape[0] for v in batch.values()
             if np.asarray(v).ndim >= 1}
    (b,) = sizes
    mask = np.zeros((target_b,), dtype=np.float32)
    mask[:b] = 1.0
    if b == target_b:
        return batch, mask
    if b > target_b:
        raise ValueError(f"batch of {b} exceeds target {target_b}")

    def pad(v):
        v = np.asarray(v)
        if v.ndim == 0:
            return v
        return np.concatenate(
            [v, np.repeat(v[-1:], target_b - b, axis=0)], axis=0
        )

    return {k: pad(v) for k, v in batch.items()}, mask


def predict_padded(steps, points, surface_samples_inputs, bucket=4096,
                   point_mask=None) -> np.ndarray:
    """Evaluate the deformation field with query-axis bucket padding.

    ``steps`` is either the dict from ``training.steps.make_steps`` (its
    ``predict`` turns numpy into tensors on the steps' device and, on the
    card, replays a captured program per padded shape) or a bare
    ``predict(points, inputs[, point_mask])`` callable, which then receives
    the padded numpy arrays.  ``point_mask`` marks real conditioning rows of
    padded partial shapes.  Returns the (B, Q, 3) numpy prediction for the
    unpadded queries.
    """
    padded, q = pad_queries(np.asarray(points), bucket)
    if callable(steps):
        args = () if point_mask is None else (point_mask,)
        out = steps(padded, surface_samples_inputs, *args)
    else:
        out = steps["predict"](padded, surface_samples_inputs, point_mask)
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return np.asarray(out)[:, :q]
