"""Radius neighbourhoods and 3-NN feature interpolation (counterpart of
``nsdp_tpu/ops/geometry.py``; reference ``ball_query_gpu.cu``,
``interpolate_gpu.cu``).  Plain PyTorch: the JAX package has no TPU kernel
for these, and the model path does not run them."""

import numpy as np
import torch

from nsdp_tpu_torch.ops.knn import square_distance


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Radius neighbourhood query with first-hit padding.

    For each centre of ``new_xyz`` (B, S, 3), the first ``nsample`` points
    of ``xyz`` (B, N, 3) in index order with squared distance < radius^2;
    rows with fewer hits are padded with the first hit, rows with none are
    all zeros.  -> (B, S, nsample) int32.
    """
    N = xyz.shape[1]
    hit = square_distance(new_xyz, xyz) < radius * radius  # (B, S, N)
    # earlier hits get larger keys, misses 0: the top keys are the first
    # hits in index order
    iota = torch.arange(N, device=xyz.device)
    key = torch.where(hit, N - iota, torch.zeros_like(iota))
    if nsample > N:  # fewer points than slots: pad the key axis
        key = torch.nn.functional.pad(key, (0, nsample - N))
    top, idx = torch.topk(key, nsample, dim=-1)
    out = torch.where(top > 0, idx, idx[..., 0:1])
    any_hit = hit.any(dim=-1, keepdim=True)
    return torch.where(any_hit, out, torch.zeros_like(out)).to(torch.int32)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The three nearest ``known`` (B, m, 3) points of each ``unknown``
    (B, n, 3) point, ties to the lowest index -> (euclidean distances
    (B, n, 3), int32 indices (B, n, 3))."""
    d2, idx = torch.sort(square_distance(unknown, known), dim=-1, stable=True)
    return torch.sqrt(torch.clamp(d2[..., :3], min=0.0)), idx[..., :3].to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbours' features: (B, C, m) features, (B, n, 3)
    indices and weights -> (B, C, n)."""
    B, C, _ = features.shape
    n = idx.shape[1]
    flat = torch.gather(features, 2, idx.reshape(B, 1, -1).long().expand(-1, C, -1))
    return torch.sum(flat.reshape(B, C, n, 3) * weight[:, None, :, :], dim=-1)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights used with :func:`three_interpolate`."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def fibonacci_sphere(samples: int = 1) -> torch.Tensor:
    """``samples`` points evenly spread on the unit sphere, (samples, 3)
    float32 (golden-angle spiral; reference ``model/utils.py:13-36``)."""
    i = np.arange(samples, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - (i / max(samples - 1, 1)) * 2.0
    radius = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    pts = np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], axis=1)
    return torch.as_tensor(pts, dtype=torch.float32)
