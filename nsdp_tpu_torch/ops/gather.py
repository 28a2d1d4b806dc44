"""Batched gathers by index (counterpart of ``nsdp_tpu.ops.gather``) and the
row gather's CUDA kernel wrapper.

:func:`gather_rows` is the counterpart of the TPU gather probes P1 and P2
(``scripts/bench_gather_prefetch.py``: the kernels inside
``onehot_gather`` and ``prefetch_gather``) and the grouping gather of the
PointNet++ set abstraction: ``out[b, s, j] = table[b, idx[b, s, j]]``.  A CPU
tensor runs :func:`gather_rows_plain`; a CUDA tensor launches the kernel of
``csrc/gather.cu`` (counted in ``gather_rows.launches``) or raises.  Its
gradient is a plain ``index_add_``: the TPU probes have no backward kernel.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from nsdp_tpu_torch.ops import _build

_SIGNATURES = {"nsdp_gather_rows": (ctypes.c_int, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])}


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


def gather_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Channel-first gather, (B, C, N) x (B, m) -> (B, C, m)
    (``pointnet2_utils.gather_operation``)."""
    C = features.shape[1]
    return torch.gather(features, 2, idx.long()[:, None, :].expand(-1, C, -1))


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhood gather, (B, C, N) x (B, np, ns) -> (B, C, np, ns)
    (``pointnet2_utils.grouping_operation``)."""
    B, C, _ = features.shape
    return gather_operation(features, idx.reshape(B, -1)).reshape(B, C, *idx.shape[1:])


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather in one PyTorch gather: (B, M, W) x (B, S, k) ->
    (B, S, k, W)."""
    return index_points(table, idx)


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dtype != torch.float32:
        raise TypeError(f"gather kernel takes a float32 table, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather kernel takes int32 indices, got {idx.dtype}")
    if table.ndim != 3 or idx.ndim != 3 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"gather kernel: expected (B, M, W) and (B, S, k), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"gather operands on {idx.device} and {table.device}")
    B, M, W = table.shape
    S, k = idx.shape[1], idx.shape[2]
    out = torch.empty((B, S, k, W), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    table, idx = table.contiguous(), idx.contiguous()
    lib = _build.load("gather", _SIGNATURES)
    err = lib.nsdp_gather_rows(table.data_ptr(), idx.data_ptr(), B, M, W, S, k, out.data_ptr(),
                               table.device.index or 0, _build.stream_of(table))
    _build.check(lib, err, f"gather kernel (B={B}, M={M}, W={W}, S={S}, k={k})")
    gather_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """The row gather forward; the table's gradient by ``index_add_`` (on
    the card its atomics sum in an order that changes from run to run)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return _launch(table, idx) if table.device.type == "cuda" else gather_rows_plain(table, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, M, W = ctx.table_shape
        offsets = torch.arange(B, device=idx.device)[:, None] * M
        flat = (idx.reshape(B, -1).long() + offsets).reshape(-1)
        grad = torch.zeros((B * M, W), dtype=g.dtype, device=g.device)
        grad.index_add_(0, flat, g.reshape(-1, W))
        return grad.reshape(B, M, W), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (B, M, W) table by (B, S, k) indices -> (B, S, k, W).

    A CPU input runs :func:`gather_rows_plain`; a CUDA input launches the
    kernel of ``csrc/gather.cu`` (float32 table, int32 indices in [0, M);
    counted in ``gather_rows.launches``) or raises.  Differentiable in
    ``table`` when grad mode is on.  A bfloat16 or float16 table (a narrow
    compute dtype) is widened to float32 around the gather, which is exact,
    and its rows come back in its own type."""
    if table.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no gather kernel for device {table.device}")
    if table.dtype in (torch.bfloat16, torch.float16):
        return gather_rows(table.float(), idx).to(table.dtype)
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return _launch(table, idx)


gather_rows.launches = 0
