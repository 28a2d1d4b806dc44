"""Point-transformer building blocks, channels-last (B, N, C), train and eval mode.

Counterparts of ``nsdp_tpu/nn/blocks.py`` (reference ``model/encoder/blocks.py``
and ``model/decoder/blocks.py``).  There is one path: every kNN vector
attention goes through :func:`nsdp_tpu_torch.ops.fused_vector_attention`,
every furthest-point sampling through
:func:`nsdp_tpu_torch.ops.furthest_point_sample`, and the max-pool set
abstraction's grouping through :func:`nsdp_tpu_torch.ops.knn.knn` and
:func:`nsdp_tpu_torch.ops.gather_rows`; only the full
self-attention over the final anchors (group-all, ~100 points) stays plain
tensor code, as in ``nsdp_tpu/models/fast_encoder.py:82-91``.

Module and parameter names follow the reference checkpoints
(``tests/torch_ref.py``): ``fc_delta.0``/``fc_delta.2``, ``w_qs``, BatchNorms
named ``bn``, ``bn1``, ``bnorm0`` ...  The reference's 1x1 ``Conv1d`` layers
(``conv1``/``conv2``) are ``nn.Linear`` here: the same function on a
channels-last layout, with the kernel dimension squeezed out.
"""

import contextlib
from contextvars import ContextVar
from typing import Optional

import numpy as np
import torch
from torch import nn

from nsdp_tpu_torch.ops import (
    fused_vector_attention,
    furthest_point_sample,
    gather_rows,
    index_points,
)
from nsdp_tpu_torch.ops.knn import knn
from nsdp_tpu_torch.parallel.dist import all_reduce_sum

# The process group whose ranks' rows make up one batch for train-mode
# BatchNorm (the counterpart of ``nsdp_tpu/nn/blocks.py:41-55``): every op
# of the model is row-wise except BatchNorm, whose statistics must span the
# whole batch for a data-parallel step to equal the single-process one.  A
# context variable carries it instead of an argument threaded through every
# module; ``training.steps.make_steps(group=...)`` enters it around the
# train-mode forward.
_BN_SYNC_GROUP: ContextVar = ContextVar("nsdp_bn_sync_group", default=None)


@contextlib.contextmanager
def bn_sync(group):
    """Within this context, train-mode BatchNorm takes its statistics over
    the rows of every rank of ``group`` (``torch.distributed``; None: this
    process's rows only)."""
    token = _BN_SYNC_GROUP.set(group)
    try:
        yield
    finally:
        _BN_SYNC_GROUP.reset(token)


class TwoLayerMLP(nn.Sequential):
    """Linear -> ReLU -> Linear, the reference's ``fc_*`` Sequentials."""

    def __init__(self, d_in: int, features: int, device=None):
        super().__init__(
            nn.Linear(d_in, features, device=device),
            nn.ReLU(),
            nn.Linear(features, features, device=device),
        )

    def kernels(self):
        """(w0, b0, w1, b1) with the weights in (in, out) layout, as the
        attention op takes them (views, no copies)."""
        return self[0].weight.t(), self[0].bias, self[2].weight.t(), self[2].bias


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis,
    ``(x - mean) * rsqrt(var + 1e-5) * scale + bias``; parameters and
    buffers are those of ``torch.nn.BatchNorm1d``.

    Eval mode uses the running statistics
    (``nsdp_tpu/models/fast_encoder.py:28-31``).  Train mode is the JAX
    package's ``_TorchExactBatchNorm`` (``nsdp_tpu/nn/blocks.py:114-199``):
    the biased batch variance over every axis but the last normalises, the
    Bessel-corrected one (``n / (n - 1)`` over the valid count) enters the
    running variance, momentum 0.1.  ``mask`` (the leading axes of ``x``,
    nonzero = valid row) weights the batch statistics; eval mode ignores it.

    Under :func:`bn_sync` the statistics span every rank's rows, as
    ``bn_sync_axis`` makes them (``nsdp_tpu/nn/blocks.py:150-176``): one
    differentiable all-reduce of the sum (with the valid count packed
    beside it where there is a mask), then one of the centred squared sum,
    and the Bessel factor over the global count.  Without a mask the global
    count is the world size times the local rows, a host number, so no
    step waits for the device; the ranks' rows are equal in number.  The
    statistics are sums over the count with or without a group, so one
    rank's result is the unsynced one bit for bit.
    """

    def __init__(self, features: int, device=None):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x, mask=None):
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * inv * self.weight + self.bias
        group = _BN_SYNC_GROUP.get()
        total = (lambda t: t) if group is None else (lambda t: all_reduce_sum(t, group))
        flat = x.reshape(-1, x.shape[-1])
        if mask is None:
            rows = flat.shape[0] * (1 if group is None else torch.distributed.get_world_size(group))
            # the Bessel factor on the host, rounded as the float32 division
            # on the device would round it: a tensor made from a Python
            # number is a copy that waits for the device
            n = np.float32(rows)
            bessel = float(n / max(n - np.float32(1.0), np.float32(1.0)))
            mean = total(flat.sum(dim=0)) / rows
            var = total(torch.square(flat - mean).sum(dim=0)) / rows
        else:
            w = mask.reshape(-1, 1).to(x.dtype)
            s, count = (flat * w).sum(dim=0), w.sum()
            if group is not None:
                packed = all_reduce_sum(torch.cat([s, count.reshape(1)]), group)
                s, count = packed[:-1], packed[-1]
            n = torch.clamp(count, min=1.0)
            bessel = n / torch.clamp(n - 1.0, min=1.0)
            mean = s / n
            var = total((torch.square(flat - mean) * w).sum(dim=0)) / n
        with torch.no_grad():
            unbiased = var * bessel
            m = 1.0 - self.momentum
            self.running_mean.copy_(m * self.running_mean + self.momentum * mean)
            self.running_var.copy_(m * self.running_var + self.momentum * unbiased)
            self.num_batches_tracked.add_(1)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class TransformerBlock(nn.Module):
    """Local (kNN) or full vector self-attention with residual + BatchNorm
    (reference ``model/encoder/blocks.py:52-134``).

    ``pos_only`` drops the q/k/v projections (logits and values are the
    position encodings; the first block of a featureless encoder);
    ``group_all`` attends every point to every point.
    """

    def __init__(self, d_model: int, k: int, pos_only: bool = False,
                 group_all: bool = False, device=None):
        super().__init__()
        if pos_only and group_all:
            raise ValueError("pos_only group-all attention is not a model block")
        self.k, self.pos_only, self.group_all = k, pos_only, group_all
        self.fc_delta = TwoLayerMLP(3, d_model, device)
        self.fc_gamma = TwoLayerMLP(d_model, d_model, device)
        if not pos_only:
            self.w_qs = nn.Linear(d_model, d_model, bias=False, device=device)
            self.w_ks = nn.Linear(d_model, d_model, bias=False, device=device)
            self.w_vs = nn.Linear(d_model, d_model, bias=False, device=device)
        self.bn = BatchNorm(d_model, device)

    def forward(self, xyz, feats=None, kv_mask=None):
        if self.group_all:
            if kv_mask is not None:
                raise ValueError("kv_mask applies to kNN attention only")
            return self.bn(self._full_attention(xyz, feats))
        if self.pos_only:
            res = fused_vector_attention(
                xyz, xyz, None, None, None,
                *self.fc_delta.kernels(), *self.fc_gamma.kernels(),
                k=self.k, kv_mask=kv_mask,
            )
        else:
            res = fused_vector_attention(
                xyz, xyz, self.w_qs(feats), self.w_ks(feats), self.w_vs(feats),
                *self.fc_delta.kernels(), *self.fc_gamma.kernels(),
                k=self.k, kv_mask=kv_mask,
            ) + feats
        return self.bn(res, kv_mask)

    def _full_attention(self, xyz, feats):
        pos = self.fc_delta(xyz[:, :, None, :] - xyz[:, None, :, :])
        q, k, v = self.w_qs(feats), self.w_ks(feats), self.w_vs(feats)
        logits = self.fc_gamma(q[:, :, None, :] - k[:, None, :, :] + pos)
        attn = torch.softmax(logits, dim=-2)
        return torch.sum(attn * (v[:, None, :, :] + pos), dim=-2) + feats


class ElementwiseMLP(nn.Module):
    """Per-point MLP with residual: D->BN->ReLU->D->BN->ReLU->(+x)->BN
    (reference ``model/encoder/blocks.py:137-159``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv1 = nn.Linear(dim, dim, device=device)
        self.bn1 = BatchNorm(dim, device)
        self.conv2 = nn.Linear(dim, dim, device=device)
        self.bn2 = BatchNorm(dim, device)
        self.bn3 = BatchNorm(dim, device)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        return self.bn3(x + h)


class TransformerSetAbstraction(nn.Module):
    """Attentive downsampling (reference ``model/encoder/blocks.py:221-313``):
    FPS picks ``npoint`` centres; each runs two rounds of vector
    cross-attention over its ``nneigh`` nearest input points, sharing the
    position encoding, with a 1x1 residual between rounds and a residual to
    the gathered input features at the end.

    The centres are picked and placed on the detached coordinates, as the
    reference does under ``torch.no_grad()`` (``nsdp_tpu/nn/blocks.py:404-423``):
    no gradient reaches the input coordinates through them, only through
    the kv set's position deltas."""

    def __init__(self, npoint: int, nneigh: int, dim: int, device=None):
        super().__init__()
        self.npoint, self.nneigh = npoint, nneigh
        self.fc_delta1 = TwoLayerMLP(3, dim, device)
        self.fc_gamma1 = TwoLayerMLP(dim, dim, device)
        self.fc_gamma2 = TwoLayerMLP(dim, dim, device)
        for name in ("w_qs", "w_ks", "w_vs", "w_qs2", "w_ks2", "w_vs2"):
            setattr(self, name, nn.Linear(dim, dim, bias=False, device=device))
        self.conv1 = nn.Linear(dim, dim, device=device)
        self.conv2 = nn.Linear(dim, dim, device=device)
        self.bn1 = BatchNorm(dim, device)
        self.bnorm0 = BatchNorm(dim, device)
        self.bnorm1 = BatchNorm(dim, device)
        self.bnorm2 = BatchNorm(dim, device)

    def forward(self, xyz, points, kv_mask=None):
        # masked points go to the origin, which FPS never selects
        xyz_ng = xyz.detach()
        fps_xyz = xyz_ng if kv_mask is None else xyz_ng * kv_mask[..., None].to(xyz.dtype)
        fps_idx = furthest_point_sample(fps_xyz, self.npoint)
        new_xyz = index_points(xyz_ng, fps_idx)
        centre_feats = index_points(points, fps_idx)
        # the TSA position encoding is (neighbour - centre), the opposite
        # sign of the other blocks (reference encoder/blocks.py:295 vs :114):
        # negating both coordinate sets flips the op's delta, keeps distances
        nq, nkv = -new_xyz, -xyz
        delta = self.fc_delta1.kernels()
        res1 = fused_vector_attention(
            nq, nkv, self.w_qs(centre_feats), self.w_ks(points), self.w_vs(points),
            *delta, *self.fc_gamma1.kernels(), k=self.nneigh, kv_mask=kv_mask,
        )
        h = torch.relu(self.bn1(self.conv1(res1)))
        res1 = self.bnorm0(res1 + self.conv2(h))
        res2 = fused_vector_attention(
            nq, nkv, self.w_qs2(res1), self.w_ks2(points), self.w_vs2(points),
            *delta, *self.fc_gamma2.kernels(), k=self.nneigh, kv_mask=kv_mask,
        )
        out = self.bnorm1(res1 + res2) + centre_feats
        return new_xyz, self.bnorm2(out)


class PointNetSetAbstraction(nn.Module):
    """PointNet++-style downsampling: FPS + kNN grouping + max-pool
    (``nsdp_tpu/nn/blocks.py:535-573``; reference
    ``model/encoder/blocks.py:162-217``), the ablation ``pointnet++``
    encoder's set abstraction.

    The FPS centres are picked on the detached coordinates (masked points
    moved to the origin, which FPS never selects) and grouped by
    :func:`nsdp_tpu_torch.ops.knn.knn` (K4) on detached coordinates, but the
    returned centres ``new_xyz`` are gathered from ``xyz`` itself: unlike
    the attentive set abstraction, gradient flows through them into the
    input coordinates (in stage 2, into the canonicalised points).  The
    grouping gather is :func:`nsdp_tpu_torch.ops.gather_rows`; the max over
    the neighbours is ``torch.amax``, whose gradient is split evenly among
    tied maxima, as ``jnp.max``'s is.  ``kv_mask`` (B, N) also weights the
    statistics of ``bn1`` and ``bn2``."""

    def __init__(self, npoint: int, nneigh: int, dim: int, device=None):
        super().__init__()
        self.npoint, self.nneigh = npoint, nneigh
        self.fc1 = nn.Linear(dim, dim, device=device)
        self.conv1 = nn.Linear(dim, dim, device=device)
        self.bn1 = BatchNorm(dim, device)
        self.conv2 = nn.Linear(dim, dim, device=device)
        self.bn2 = BatchNorm(dim, device)
        self.bn = BatchNorm(dim, device)

    def forward(self, xyz, points, kv_mask=None):
        xyz_ng = xyz.detach()
        fps_xyz = xyz_ng if kv_mask is None else xyz_ng * kv_mask[..., None].to(xyz.dtype)
        fps_idx = furthest_point_sample(fps_xyz, self.npoint)
        new_xyz = index_points(xyz, fps_idx)
        points = self.fc1(points)
        points_ori = index_points(points, fps_idx)
        h = torch.relu(self.bn1(self.conv1(points), kv_mask))
        h = torch.relu(self.bn2(self.conv2(h), kv_mask))
        points = points + h
        idx = knn(new_xyz.detach(), xyz_ng, self.nneigh, kv_mask=kv_mask)
        grouped = gather_rows(points, idx)
        new_points = self.bn(points_ori + torch.amax(grouped, dim=2))
        return new_xyz, new_points


class TransitionDown(nn.Module):
    """Downsampling wrapper (reference ``model/encoder/blocks.py:18-49``):
    ``sa_type`` 'attentive' (:class:`TransformerSetAbstraction`) or
    'maxpool' (:class:`PointNetSetAbstraction`)."""

    def __init__(self, npoint: int, nneigh: int, dim: int, sa_type: str = "attentive",
                 device=None):
        super().__init__()
        if sa_type == "attentive":
            self.sa = TransformerSetAbstraction(npoint, nneigh, dim, device)
        elif sa_type == "maxpool":
            self.sa = PointNetSetAbstraction(npoint, nneigh, dim, device)
        else:
            raise ValueError(f"unknown set abstraction type {sa_type!r}")

    def forward(self, xyz, points, kv_mask=None):
        return self.sa(xyz, points, kv_mask)


class CrossTransformerBlock(nn.Module):
    """Query points cross-attend to their nearest anchors plus a global
    token with zero position encoding (reference
    ``model/decoder/blocks.py:12-95``), for a 2-D global latent."""

    def __init__(self, dim_inp: int, dim: int, nneigh: int = 7, device=None):
        super().__init__()
        self.nneigh = nneigh
        self.fc_delta = TwoLayerMLP(3, dim, device)
        self.fc_gamma = TwoLayerMLP(dim, dim, device)
        for name in ("w_k_global", "w_v_global", "w_qs", "w_ks", "w_vs"):
            setattr(self, name, nn.Linear(dim_inp, dim, bias=False, device=device))

    def forward(self, xyz_q, lat_rep, xyz, points):
        B, Q, _ = xyz_q.shape
        q_glob = self.w_qs(lat_rep)
        # every query shares the global latent's projection: a broadcast
        # view, which the kernel reads with a zero query stride
        qf = q_glob[:, None, :].expand(B, Q, q_glob.shape[-1])
        return fused_vector_attention(
            xyz_q, xyz, qf, self.w_ks(points), self.w_vs(points),
            *self.fc_delta.kernels(), *self.fc_gamma.kernels(),
            k=self.nneigh,
            k_glob=self.w_k_global(lat_rep), v_glob=self.w_v_global(lat_rep),
        )


class ResnetBlockFC(nn.Module):
    """Fully-connected ResNet block (reference ``model/decoder/blocks.py:99-142``):
    ``out = shortcut(x) + fc_1(relu(fc_0(relu(x))))``; the bias-free
    ``shortcut`` exists only when the widths differ.  ``fc_1``'s weight
    starts at zero, so a new block is the identity."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, device=None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h, device=device)
        self.fc_1 = nn.Linear(size_h, size_out, device=device)
        nn.init.zeros_(self.fc_1.weight)
        if size_in != size_out:
            self.shortcut = nn.Linear(size_in, size_out, bias=False, device=device)

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        x_s = self.shortcut(x) if hasattr(self, "shortcut") else x
        return x_s + dx
