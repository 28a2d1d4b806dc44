"""k nearest points: plain PyTorch version and the CUDA kernel's wrapper.

Counterpart of ``nsdp_tpu/ops/knn.py`` and ``nsdp_tpu/ops/knn_pallas.py``.
Semantics (``knn_pallas.py:30-67``): per query the k nearest points by
``d2 = penalty + sum_c (q_c - p_c)^2``, exact in the input's dtype and
summed in that order, ascending, ties to the lowest index; ``kv_mask`` adds
the finite penalty of :func:`mask_penalty`; k > M raises.  The squared
distances returned with ``return_dist`` include the penalty, as the TPU
kernel returns them.

The kernel (``csrc/knn.cu``, K4) replaces the TPU kernel ``_knn_kernel``:
:func:`split_warps` chooses how many warps share one query's cloud, each
selecting among a part of it, and :func:`two_pass` whether a first pass
bounds the k-th nearest distance before the lists are fed; the parts'
lists merge by (d2, index).  The same selection is the neighbourhood of the
fused attention's plain version (``ops/attention.py``), so one function,
:func:`select`, defines it.
"""

import ctypes
from typing import Optional

import torch

from nsdp_tpu_torch.ops import _build

KMAX = 32  # largest k the kernel takes
MAX_SPLIT = 8  # warps of a block, the most that share one query's cloud
SPLIT_BELOW = 4  # queries an SM below which a query's cloud is split
PART_POINTS = 64  # the fewest points a part keeps: 2 a lane
RESIDENT_WARPS = 8  # warps an SM takes before more parts stop paying (H100)
TWO_PASS_POINTS = 32  # points a lane from which the bound pass pays
_SIGNATURES = {"nsdp_knn": (ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])}


def split_warps(B: int, Nq: int, M: int, sms: int = 132) -> int:
    """Warps that share one query's cloud (1, 2, 4 or 8): 1 where the B *
    Nq queries number ``SPLIT_BELOW`` an SM of the card's ``sms`` or more;
    else the most that leave every part at least ``PART_POINTS`` points and
    the queries' warps within ``RESIDENT_WARPS`` an SM.  On an H100 (132
    SMs): 1 at the 32-point probe and at every B = 8 site, 2 at the set
    abstraction's 500 x 5000 and 4 at its 100 x 500 at B = 1 (the fastest
    W at each site measured)."""
    if B * Nq >= SPLIT_BELOW * sms:
        return 1
    w = 1
    while (2 * w <= MAX_SPLIT and 2 * w * PART_POINTS <= M
           and B * Nq * 2 * w <= sms * RESIDENT_WARPS):
        w *= 2
    return w


def two_pass(M: int, w: int) -> bool:
    """Whether K4 first bounds the k-th nearest distance, so that its
    second pass feeds its candidate lists only with points below the
    bound: where each lane of the w warps scans ``TWO_PASS_POINTS`` or
    more of the M points (a shorter scan costs more than the insertions it
    saves)."""
    return M >= 32 * w * TWO_PASS_POINTS


def mask_penalty(kv_mask: torch.Tensor) -> torch.Tensor:
    """Additive squared-distance penalty for masked kv points
    (``nsdp_tpu/ops/knn.py:21-30``).

    Finite 1e30 rather than inf: it keeps the selection's comparisons exact
    while dwarfing any real squared distance, so masked points sort after
    every selectable one.  ``(B, M)`` mask, nonzero = selectable.
    """
    return (kv_mask == 0).to(torch.float32) * 1e30


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance, (B, N, C) x (B, M, C) -> (B, N, M), in the
    JAX package's form ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0
    (``nsdp_tpu/ops/knn.py:33-47``)."""
    d2 = (src * src).sum(-1)[..., :, None] + (dst * dst).sum(-1)[..., None, :]
    # mixed types promote, as in jnp.einsum (a bfloat16 query set against
    # float32 anchors under a narrow compute dtype)
    both = torch.promote_types(src.dtype, dst.dtype)
    d2 = d2 - 2.0 * torch.einsum("bnc,bmc->bnm", src.to(both), dst.to(both))
    return torch.clamp(d2, min=0.0)


def select(query: torch.Tensor, points: torch.Tensor, k: int,
           penalty: Optional[torch.Tensor] = None):
    """(indices (B, Nq, k) int64, squared distances (B, Nq, k)) of the k
    nearest points, ascending, ties to the lowest index.
    ``d2 = penalty + sum_c (q_c - p_c)^2`` summed in that order, as the
    kernels do (no penalty: the sum starts from zero, which adds nothing)."""
    B, M = points.shape[0], points.shape[1]
    if penalty is None:
        penalty = torch.zeros((B, M), dtype=torch.float32, device=points.device)
    d2 = penalty[:, None, :]
    for c in range(3):
        diff = query[:, :, None, c] - points[:, None, :, c]
        d2 = d2 + diff * diff
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    return idx[..., :k], d2[..., :k]


def _check_k(k: int, M: int) -> None:
    if k > M:
        raise ValueError(f"k={k} > number of points {M}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")


def knn_plain(query: torch.Tensor, points: torch.Tensor, k: int, return_dist: bool = False,
              kv_mask: Optional[torch.Tensor] = None):
    """K4's plain version: (B, Nq, 3) x (B, M, 3) -> (B, Nq, k) int32
    indices (and the (B, Nq, k) squared distances with ``return_dist``)."""
    if query.shape[-1] != 3 or points.shape[-1] != 3:
        raise ValueError("knn expects 3-D coordinates")
    _check_k(k, points.shape[1])
    penalty = None if kv_mask is None else mask_penalty(kv_mask)
    idx, d2 = select(query, points, k, penalty)
    idx = idx.to(torch.int32)
    return (idx, d2) if return_dist else idx


def _launch(query, points, k, return_dist, kv_mask, warps=None):
    """K4 on the card; ``warps`` overrides :func:`split_warps` (the tests'
    parts of fewer than k points)."""
    for name, t in (("query", query), ("points", points), ("kv_mask", kv_mask)):
        if t is None:
            continue
        if t.device != query.device:
            raise ValueError(f"knn operands on {t.device} and {query.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"knn kernel takes float32, got {t.dtype} for {name}")
    if query.ndim != 3 or points.ndim != 3 or query.shape[-1] != 3 or points.shape[-1] != 3 \
            or points.shape[0] != query.shape[0]:
        raise ValueError(f"knn kernel: expected (B, Nq, 3) and (B, M, 3), got "
                         f"{tuple(query.shape)} and {tuple(points.shape)}")
    B, Nq, M = query.shape[0], query.shape[1], points.shape[1]
    _check_k(k, M)
    if k > KMAX:
        raise ValueError(f"knn kernel takes k <= {KMAX}, got {k}")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, M):
        raise ValueError(f"knn kernel: kv_mask has shape {tuple(kv_mask.shape)}, expected {(B, M)}")
    idx = torch.empty((B, Nq, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((B, Nq, k), dtype=torch.float32, device=query.device) if return_dist else None
    if Nq > 0:
        query, points = query.contiguous(), points.contiguous()
        penalty = None if kv_mask is None else mask_penalty(kv_mask).contiguous()
        sms = torch.cuda.get_device_properties(query.device).multi_processor_count
        w = split_warps(B, Nq, M, sms) if warps is None else warps
        lib = _build.load("knn", _SIGNATURES)
        err = lib.nsdp_knn(query.data_ptr(), points.data_ptr(),
                           None if penalty is None else penalty.data_ptr(), B, Nq, M, k, w,
                           int(two_pass(M, w)), idx.data_ptr(),
                           None if dist is None else dist.data_ptr(),
                           query.device.index or 0, _build.stream_of(query))
        _build.check(lib, err, f"knn kernel (B={B}, Nq={Nq}, M={M}, k={k}, W={w})")
        knn.launches += 1
    return (idx, dist) if return_dist else idx


def knn(query: torch.Tensor, points: torch.Tensor, k: int, return_dist: bool = False,
        kv_mask: Optional[torch.Tensor] = None):
    """Indices of the k nearest points of each query.

    Args:
      query: (B, Nq, 3) query positions.
      points: (B, M, 3) reference positions.
      k: neighbourhood size; k > M raises.
      return_dist: also return the (B, Nq, k) squared distances.
      kv_mask: optional (B, M), nonzero = selectable.

    Returns:
      (B, Nq, k) int32 indices, ordered by increasing distance (and the
      squared distances with ``return_dist``).  A CPU input runs
      :func:`knn_plain`; a CUDA input launches the kernel of
      ``csrc/knn.cu`` with :func:`split_warps` warps a query and
      :func:`two_pass` (counted in ``knn.launches``) or raises.  No
      gradient flows through a selection.
    """
    if query.device.type == "cpu":
        return knn_plain(query, points, k, return_dist, kv_mask)
    if query.device.type != "cuda":
        raise RuntimeError(f"no knn kernel for device {query.device}")
    return _launch(query, points, k, return_dist, kv_mask)


knn.launches = 0
