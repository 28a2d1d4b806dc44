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
(``conv1``/``conv2``) are linear layers here: the same function on a
channels-last layout, with the kernel dimension squeezed out.

``dtype`` is the model's compute dtype (``model.compute_dtype``; None:
float32), threaded as the JAX package threads it: every layer that flax
builds with ``dtype=self.dtype`` is a :class:`Dense` or :class:`BatchNorm`
of that dtype here, every layer it builds without one a :class:`Dense` of
``dtype=None``, which promotes its input to float32 as flax does.
Parameters and BatchNorm statistics stay float32.  The kernels take
float32: their wrappers widen narrow operands (``ops/attention.py``,
``ops/gather.py``), and coordinates stay float32 throughout.
"""

import contextlib
from contextvars import ContextVar
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nsdp_tpu_torch.ops import (
    fused_vector_attention,
    furthest_point_sample,
    gather_rows,
    index_points,
)
from nsdp_tpu_torch.ops.attention import context_dtype, kv_proj_profitable
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


# Set while ``torch.utils.checkpoint`` recomputes a forward for the
# backward (``models/deformation.py``, ``model.remat``): a train-mode
# BatchNorm then normalises as before but leaves its running statistics
# alone, which the first forward already updated.
_RECOMPUTING: ContextVar = ContextVar("nsdp_bn_recomputing", default=False)


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


def checkpoint_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: nothing around the
    forward; around its recompute, the BatchNorm process group of that
    forward (captured here: the backward may run on another thread) and no
    running-statistics update."""
    group = _BN_SYNC_GROUP.get()

    @contextlib.contextmanager
    def recompute():
        tokens = _BN_SYNC_GROUP.set(group), _RECOMPUTING.set(True)
        try:
            yield
        finally:
            _RECOMPUTING.reset(tokens[1])
            _BN_SYNC_GROUP.reset(tokens[0])

    return contextlib.nullcontext(), recompute()


def dense(x, weight, bias, dtype):
    """flax's ``Dense(dtype=dtype)`` with an (out, in) ``weight``.

    ``dtype=None``: the input is promoted to the parameters' type (a
    bfloat16 input times a float32 kernel computes and returns float32).
    Else the input, the kernel and the bias are cast to ``dtype`` and the
    product is rounded to it before the bias add, as flax rounds it (not a
    fused ``addmm``)."""
    if dtype is None:
        return F.linear(x if x.dtype == weight.dtype else x.to(weight.dtype), weight, bias)
    y = x.to(dtype) @ weight.to(dtype).t()
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` as :func:`dense` does; the
    parameters stay float32, with ``nn.Linear``'s names and layout."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None, dtype=None):
        super().__init__(d_in, d_out, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.dtype)


def keys_values(w_ks: Dense, w_vs: Dense, feats):
    """``(K_a, V_a, projection kwargs)`` of a featured kNN attention whose
    kv points carry ``feats`` (B, M, F).

    Where the JAX package projects K/V inside its kernel
    (``ops.attention.kv_proj_profitable``; its fused sites,
    ``nsdp_tpu/nn/blocks.py:305-306,444-446``, and its fast encoder) the
    projection is float32 from the widened features, whatever the compute
    dtype; under K1's narrow mode (``ops.attention.attention_dtype``) the
    call takes the projection mode itself, which rounds the features and
    the weights but not V.  Elsewhere ``w_ks``/``w_vs`` compute in their own
    dtype, as the JAX package's ``Dense`` layers do.  In float32 every
    route gives the same numbers."""
    if not kv_proj_profitable(feats.shape[1], feats.shape[-1], w_ks.out_features):
        return w_ks(feats), w_vs(feats), {}
    if context_dtype() is not None:
        return None, None, dict(kv_feats=feats, wk=w_ks.weight.t(), wv=w_vs.weight.t())
    return dense(feats, w_ks.weight, None, None), dense(feats, w_vs.weight, None, None), {}


class TwoLayerMLP(nn.Sequential):
    """Linear -> ReLU -> Linear, the reference's ``fc_*`` Sequentials."""

    def __init__(self, d_in: int, features: int, device=None, dtype=None):
        super().__init__(
            Dense(d_in, features, device=device, dtype=dtype),
            nn.ReLU(),
            Dense(features, features, device=device, dtype=dtype),
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
    rank's result is the unsynced one bit for bit.  Nothing here reads a
    device value on the host or makes a tensor from a Python number (the
    Bessel factor and the momentum enter as kernel arguments), so a train
    step under an NCCL group is captured with these all-reduces inside
    its graph (``training.steps.make_steps``).

    ``dtype`` (flax's ``BatchNorm(dtype=)``, ``nsdp_tpu/nn/blocks.py:148-199``):
    the statistics and the normalisation are taken in the parameters'
    float32 (all-reduced sums included), the output is cast to ``dtype``
    (None: the input's dtype).  ``BatchNorm.widened_bytes`` counts the
    bytes of narrow input taken to float32, at the call (a replay of a
    captured call adds nothing).
    """

    widened_bytes = 0

    def __init__(self, features: int, device=None, dtype=None):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device)
        self.dtype = dtype

    def forward(self, x, mask=None):
        out_dtype = self.dtype or x.dtype
        # casts only where the types differ: the float32 path makes no call
        # it did not make before (a step's launches are queued by the host)
        out = lambda y: y if y.dtype == out_dtype else y.to(out_dtype)
        if x.dtype != self.weight.dtype:
            BatchNorm.widened_bytes += x.numel() * x.element_size()
            x = x.to(self.weight.dtype)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return out((x - self.running_mean) * inv * self.weight + self.bias)
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
        if not _RECOMPUTING.get():
            with torch.no_grad():
                unbiased = var * bessel
                m = 1.0 - self.momentum
                self.running_mean.copy_(m * self.running_mean + self.momentum * mean)
                self.running_var.copy_(m * self.running_var + self.momentum * unbiased)
                self.num_batches_tracked.add_(1)
        return out((x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias)


class TransformerBlock(nn.Module):
    """Local (kNN) or full vector self-attention with residual + BatchNorm
    (reference ``model/encoder/blocks.py:52-134``).

    ``pos_only`` drops the q/k/v projections (logits and values are the
    position encodings; the first block of a featureless encoder);
    ``group_all`` attends every point to every point.  The kNN branch's
    projections take no ``dtype``, as the JAX package's fused branch
    builds them (``nsdp_tpu/nn/blocks.py:286,313-318``): they compute
    float32.
    """

    def __init__(self, d_model: int, k: int, pos_only: bool = False,
                 group_all: bool = False, device=None, dtype=None):
        super().__init__()
        if pos_only and group_all:
            raise ValueError("pos_only group-all attention is not a model block")
        self.k, self.pos_only, self.group_all = k, pos_only, group_all
        self.dtype = dtype
        self.fc_delta = TwoLayerMLP(3, d_model, device, dtype)
        self.fc_gamma = TwoLayerMLP(d_model, d_model, device, dtype)
        if not pos_only:
            proj = dtype if group_all else None
            self.w_qs = Dense(d_model, d_model, bias=False, device=device, dtype=proj)
            self.w_ks = Dense(d_model, d_model, bias=False, device=device, dtype=proj)
            self.w_vs = Dense(d_model, d_model, bias=False, device=device, dtype=proj)
        self.bn = BatchNorm(d_model, device, dtype)

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
            # q before K and V: the order autograd sums feats' gradients in
            q = self.w_qs(feats)
            K, V, proj = keys_values(self.w_ks, self.w_vs, feats)
            res = fused_vector_attention(
                xyz, xyz, q, K, V,
                *self.fc_delta.kernels(), *self.fc_gamma.kernels(),
                k=self.k, kv_mask=kv_mask, **proj,
            ) + feats
        return self.bn(res, kv_mask)

    def _full_attention(self, xyz, feats):
        pos = self.fc_delta(xyz[:, :, None, :] - xyz[:, None, :, :])
        q, k, v = self.w_qs(feats), self.w_ks(feats), self.w_vs(feats)
        logits = self.fc_gamma(q[:, :, None, :] - k[:, None, :, :] + pos)
        if self.dtype is None:
            attn = torch.softmax(logits, dim=-2)
        else:  # jax.nn.softmax's steps, each rounded to the narrow type
            e = torch.exp(logits - logits.amax(dim=-2, keepdim=True))
            attn = e / e.sum(dim=-2, keepdim=True)
        return torch.sum(attn * (v[:, None, :, :] + pos), dim=-2) + feats


class ElementwiseMLP(nn.Module):
    """Per-point MLP with residual: D->BN->ReLU->D->BN->ReLU->(+x)->BN
    (reference ``model/encoder/blocks.py:137-159``)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.conv1 = Dense(dim, dim, device=device, dtype=dtype)
        self.bn1 = BatchNorm(dim, device, dtype)
        self.conv2 = Dense(dim, dim, device=device, dtype=dtype)
        self.bn2 = BatchNorm(dim, device, dtype)
        self.bn3 = BatchNorm(dim, device, dtype)

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
    the kv set's position deltas.

    Its K/V projections follow :func:`keys_values`."""

    def __init__(self, npoint: int, nneigh: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.npoint, self.nneigh = npoint, nneigh
        self.fc_delta1 = TwoLayerMLP(3, dim, device)
        self.fc_gamma1 = TwoLayerMLP(dim, dim, device)
        self.fc_gamma2 = TwoLayerMLP(dim, dim, device)
        for name in ("w_qs", "w_ks", "w_vs", "w_qs2", "w_ks2", "w_vs2"):
            setattr(self, name, Dense(dim, dim, bias=False, device=device, dtype=dtype))
        self.conv1 = Dense(dim, dim, device=device, dtype=dtype)
        self.conv2 = Dense(dim, dim, device=device, dtype=dtype)
        self.bn1 = BatchNorm(dim, device, dtype)
        self.bnorm0 = BatchNorm(dim, device, dtype)
        self.bnorm1 = BatchNorm(dim, device, dtype)
        self.bnorm2 = BatchNorm(dim, device, dtype)

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
        q = self.w_qs(centre_feats)
        K, V, proj = keys_values(self.w_ks, self.w_vs, points)
        res1 = fused_vector_attention(
            nq, nkv, q, K, V,
            *delta, *self.fc_gamma1.kernels(), k=self.nneigh, kv_mask=kv_mask, **proj,
        )
        h = torch.relu(self.bn1(self.conv1(res1)))
        res1 = self.bnorm0(res1 + self.conv2(h))
        q = self.w_qs2(res1)
        K, V, proj = keys_values(self.w_ks2, self.w_vs2, points)
        res2 = fused_vector_attention(
            nq, nkv, q, K, V,
            *delta, *self.fc_gamma2.kernels(), k=self.nneigh, kv_mask=kv_mask, **proj,
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

    def __init__(self, npoint: int, nneigh: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.npoint, self.nneigh = npoint, nneigh
        self.fc1 = Dense(dim, dim, device=device, dtype=dtype)
        self.conv1 = Dense(dim, dim, device=device, dtype=dtype)
        self.bn1 = BatchNorm(dim, device, dtype)
        self.conv2 = Dense(dim, dim, device=device, dtype=dtype)
        self.bn2 = BatchNorm(dim, device, dtype)
        self.bn = BatchNorm(dim, device, dtype)

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
                 device=None, dtype=None):
        super().__init__()
        if sa_type == "attentive":
            self.sa = TransformerSetAbstraction(npoint, nneigh, dim, device, dtype)
        elif sa_type == "maxpool":
            self.sa = PointNetSetAbstraction(npoint, nneigh, dim, device, dtype)
        else:
            raise ValueError(f"unknown set abstraction type {sa_type!r}")

    def forward(self, xyz, points, kv_mask=None):
        return self.sa(xyz, points, kv_mask)


class CrossTransformerBlock(nn.Module):
    """Query points cross-attend to their nearest anchors plus a global
    token with zero position encoding (reference
    ``model/decoder/blocks.py:12-95``), for a 2-D global latent.  The five
    projections compute in ``dtype``: the JAX package's fused branch builds
    them through its ``dense`` helper, which passes ``dtype=self.dtype``
    (``nsdp_tpu/nn/blocks.py:626-628,635-637,649``)."""

    def __init__(self, dim_inp: int, dim: int, nneigh: int = 7, device=None, dtype=None):
        super().__init__()
        self.nneigh = nneigh
        self.fc_delta = TwoLayerMLP(3, dim, device)
        self.fc_gamma = TwoLayerMLP(dim, dim, device)
        for name in ("w_k_global", "w_v_global", "w_qs", "w_ks", "w_vs"):
            setattr(self, name, Dense(dim_inp, dim, bias=False, device=device, dtype=dtype))

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
                 size_h: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = Dense(size_in, size_h, device=device, dtype=dtype)
        self.fc_1 = Dense(size_h, size_out, device=device, dtype=dtype)
        nn.init.zeros_(self.fc_1.weight)
        if size_in != size_out:
            self.shortcut = Dense(size_in, size_out, bias=False, device=device, dtype=dtype)

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        x_s = self.shortcut(x) if hasattr(self, "shortcut") else x
        return x_s + dx
