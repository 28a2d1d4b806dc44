"""API-compatibility layer mirroring the reference's ``pointnet2_ops``
(counterpart of ``nsdp_tpu/ops/pointnet2_compat.py``).

``QueryAndGroup`` / ``GroupAll`` and ``PointnetSAModule(MSG)`` /
``PointnetFPModule`` for ablation or extension code written against the
pointnet2 API; the NSDP model path does not use them.  Positions are
channels-last (B, N, 3), features channels-first (B, C, N).

Flax infers a layer's input width at its first call; these modules take it
at construction instead (``in_channels``: the feature channels, without
the 3 that ``use_xyz`` adds).  The shared MLPs' BatchNorm is flax's own
(:class:`FlaxBatchNorm`): momentum 0.9 (torch's 0.1), eps 1e-5, and the
running variance updated with the biased batch variance.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from nsdp_tpu_torch.ops.fps import furthest_point_sample
from nsdp_tpu_torch.ops.gather import gather_operation, grouping_operation
from nsdp_tpu_torch.ops.geometry import ball_query, interpolation_weights, three_interpolate, three_nn


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor] = None, use_xyz: bool = True) -> torch.Tensor:
    """Ball-query grouping: (B, N, 3), (B, S, 3)[, (B, C, N)] ->
    (B, C(+3), S, nsample), grouped xyz relative to their centre."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = grouping_operation(xyz.transpose(1, 2), idx)  # (B, 3, S, nsample)
    grouped_xyz = grouped_xyz - new_xyz.transpose(1, 2)[..., None]
    if features is not None:
        grouped_features = grouping_operation(features, idx)
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=1)
        return grouped_features
    if not use_xyz:
        raise ValueError("cannot have not features and not use xyz")
    return grouped_xyz


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
              use_xyz: bool = True) -> torch.Tensor:
    """Single-group variant: (B, N, 3)[, (B, C, N)] -> (B, C(+3), 1, N)."""
    grouped_xyz = xyz.transpose(1, 2)[:, :, None, :]
    if features is not None:
        grouped_features = features[:, :, None, :]
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=1)
        return grouped_features
    return grouped_xyz


class FlaxBatchNorm(nn.BatchNorm1d):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last
    axis: train mode normalises with the batch mean and the biased variance
    ``max(E[x^2] - E[x]^2, 0)`` and moves the running statistics by
    ``0.9 * old + 0.1 * batch`` (the biased variance, unlike torch); eval
    mode uses the running statistics."""

    def __init__(self, features: int, device=None):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = torch.clamp((flat * flat).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked.add_(1)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class SharedMLP(nn.Module):
    """1x1 convolution + BatchNorm + ReLU stack over (B, C, S, nsample),
    channels-last inside; layer i is ``conv{i}`` / ``bn{i}``."""

    def __init__(self, in_channels: int, channels: Sequence[int], device=None):
        super().__init__()
        widths = [in_channels, *channels]
        for i, c in enumerate(channels):
            setattr(self, f"conv{i}", nn.Linear(widths[i], c, device=device))
            setattr(self, f"bn{i}", FlaxBatchNorm(c, device))
        self.n_layers = len(channels)

    def forward(self, x):
        h = torch.movedim(x, 1, -1)
        for i in range(self.n_layers):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        return torch.movedim(h, -1, 1)


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (``pointnet2_modules.py``):
    FPS centres (or one centre at the origin, ``npoint=None``, grouping
    everything), per scale a ball-query grouping, a shared MLP and a max
    over the group; the scales' features concatenated.  ``in_channels`` is
    the feature channel count (0 without features)."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], use_xyz: bool = True, in_channels: int = 0,
                 device=None):
        super().__init__()
        self.npoint, self.radii, self.nsamples, self.use_xyz = npoint, radii, nsamples, use_xyz
        width = in_channels + (3 if use_xyz else 0)
        for i, mlp in enumerate(mlps):
            setattr(self, f"mlp{i}", SharedMLP(width, mlp, device))

    def forward(self, xyz, features=None):
        if self.npoint is not None:
            fps_idx = furthest_point_sample(xyz, self.npoint)
            new_xyz = gather_operation(xyz.transpose(1, 2), fps_idx).transpose(1, 2)
        else:
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype, device=xyz.device)
        outs: List[torch.Tensor] = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            if self.npoint is not None:
                grouped = query_and_group(radius, nsample, xyz, new_xyz, features, self.use_xyz)
            else:
                grouped = group_all(xyz, features, self.use_xyz)
            outs.append(torch.amax(getattr(self, f"mlp{i}")(grouped), dim=-1))  # (B, C, S)
        return new_xyz, torch.cat(outs, dim=1)


class PointnetSAModule(PointnetSAModuleMSG):
    """Single-scale set abstraction."""

    @classmethod
    def create(cls, mlp, npoint=None, radius=None, nsample=None, use_xyz=True, in_channels=0,
               device=None):
        return cls(npoint=npoint, radii=[radius], nsamples=[nsample], mlps=[mlp],
                   use_xyz=use_xyz, in_channels=in_channels, device=device)


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation of the known
    features at the unknown points, the skip features appended, a shared
    MLP.  ``in_channels`` = known feature channels + skip feature
    channels."""

    def __init__(self, mlp: Sequence[int], in_channels: int, device=None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, device)

    def forward(self, unknown, known, unknow_feats, known_feats):
        if known is not None:
            dist, idx = three_nn(unknown, known)
            interpolated = three_interpolate(known_feats, idx, interpolation_weights(dist))
        else:
            interpolated = known_feats[..., 0:1].expand(*known_feats.shape[:2], unknown.shape[1])
        if unknow_feats is not None:
            new_features = torch.cat([interpolated, unknow_feats], dim=1)
        else:
            new_features = interpolated
        return self.mlp(new_features[..., None])[..., 0]
