"""Furthest-point sampling: plain PyTorch version and the CUDA kernel's wrapper.

Semantics (``nsdp_tpu/ops/fps.py:1-19``, reference ``sampling_gpu.cu``): the
first index is always 0; points with ``|p|^2 <= 1e-3`` are never selected and
never update the running min-distance, which starts at 1e10; each step takes
the arg-max of the running min-distance, ties to the lowest index; an
all-invalid cloud picks 0.

The kernel (``csrc/fps.cu``) replaces the TPU kernel
``nsdp_tpu/ops/fps_pallas.py::_fps_kernel``; see the note at the top of the
source for what bounds it on the card.  It has three variants, which
:func:`variant` chooses by the cloud's size: up to ``SMEM_POINTS`` points
one block keeps the whole cloud in shared memory, 16 bytes a point; up to
``CLUSTER_POINTS`` a thread-block cluster of 8 blocks splits it into 8
ranges, each in one block's shared memory; a larger cloud keeps the running
min-distance in a (B, N) scratch on the card that the wrapper allocates.
"""

import ctypes

import torch

from nsdp_tpu_torch.ops import _build

# (227 KB of shared memory a Hopper block may opt in to, less 512 bytes of
# static arrays) / 16 bytes a point: the largest cloud the shared-memory
# variant takes (csrc/fps.cu kSmemPoints); above it the cluster variant.
SMEM_POINTS = (232448 - 512) // 16
# The cluster variant (csrc/fps.cu kMaxCluster, kClusterBlockPoints): 8
# blocks, the portable cluster size and the fastest at every size measured,
# each holding up to (227 KB less 1 KB of static arrays) / 16 bytes a point.
MAX_CLUSTER = 8
CLUSTER_BLOCK_POINTS = (232448 - 1024) // 16
CLUSTER_POINTS = MAX_CLUSTER * CLUSTER_BLOCK_POINTS
_SIGNATURES = {"nsdp_fps": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])}


def variant(n: int):
    """The kernel's variant for an n-point cloud: ``("shared", 1)`` up to
    ``SMEM_POINTS`` (14,496) points, ``("cluster", 8)`` up to
    ``CLUSTER_POINTS`` (115,712), ``("global", 1)`` above."""
    if n <= SMEM_POINTS:
        return "shared", 1
    if n <= CLUSTER_POINTS:
        return "cluster", MAX_CLUSTER
    return "global", 1


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32, one vectorised step per sample.

    Squared norms and distances are summed as ``(x*x + y*y) + z*z`` -- the
    order the kernel writes out without FMA contraction, so both agree on
    every index.
    """
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) input, got {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    valid = (x * x + y * y + z * z) > 1e-3
    min_dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    neg_inf = torch.tensor(float("-inf"), device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx + dy * dy + dz * dz
        min_dist = torch.where(valid, torch.minimum(min_dist, d), min_dist)
        last = torch.argmax(torch.where(valid, min_dist, neg_inf), dim=-1)
        idxs[:, i] = last.to(torch.int32)
    return idxs


def _launch(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    if xyz.dtype != torch.float32:
        raise TypeError(f"furthest_point_sample kernel takes float32, got {xyz.dtype}")
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) input, got {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    kind, c = variant(N)
    lib = _build.load("fps", _SIGNATURES)
    xyz = xyz.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
               if kind == "global" else None)
    err = lib.nsdp_fps(xyz.data_ptr(), B, N, npoint, c,
                       None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                       xyz.device.index or 0, _build.stream_of(xyz))
    _build.check(lib, err, f"fps kernel (B={B}, N={N}, npoint={npoint}, {kind}, C={c})")
    furthest_point_sample.launches += 1
    if kind == "cluster":
        furthest_point_sample.cluster_launches += 1
    elif kind == "global":
        furthest_point_sample.global_launches += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Furthest-point sampling, (B, N, 3) -> (B, npoint) int32 indices.

    A CPU tensor runs :func:`furthest_point_sample_plain`; a CUDA tensor
    launches the kernel of ``csrc/fps.cu`` (the variant :func:`variant`
    names, for any N) and counts the launch in
    ``furthest_point_sample.launches``, a launch of the cluster variant also
    in ``.cluster_launches`` and one above ``CLUSTER_POINTS`` in
    ``.global_launches``.
    """
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise RuntimeError(f"no FPS kernel for device {xyz.device}")
    return _launch(xyz, npoint)


furthest_point_sample.launches = 0
furthest_point_sample.cluster_launches = 0
furthest_point_sample.global_launches = 0
