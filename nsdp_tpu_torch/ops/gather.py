"""Batched gather by index (counterpart of ``nsdp_tpu.ops.gather``)."""

import torch


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather point features by index, API-compatible with the reference's
    ``index_points`` (``model/utils.py:58-70``).

    Args:
      points: (B, N, C).
      idx: (B, S) or (B, S, K) integer indices into the N axis.

    Returns:
      (B, S, C) or (B, S, K, C).
    """
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)
