"""Fused kNN vector attention: plain PyTorch version and the CUDA kernel's wrapper.

Counterpart of ``nsdp_tpu/ops/attention_pallas.py::fused_vector_attention``
(forward only), with the same arguments except the TPU-only ones (``tile``,
``interpret``, ``exact_self``, ``compute_dtype``, ``return_idx``,
``save_residuals``).  Weights are (in, out) matrices, the JAX package's
``kernel`` layout, so the same arrays feed both packages.  The kernel reads
them in ``nn.Linear``'s (out, in) layout: the transposed views of
``nn.Linear`` weights that the modules pass are read in place, and only an
(in, out) array laid out row by row is copied.

Per query (reference ``model/encoder/blocks.py``, ``model/decoder/blocks.py``):
the k nearest kv points by exact f32 squared distance (plus the ``kv_mask``
penalty), ties to the lowest index; per neighbour slot
``pos = fc_delta(x_q - x_kv)`` and

* pos-only (``q_feats is None``): ``logits = fc_gamma(pos)``, ``value = pos``;
* featured: ``logits = fc_gamma(q - k_n + pos)``, ``value = v_n + pos`` with
  ``k_n``/``v_n`` rows of the K/V tables, or of ``kv_feats @ wk`` /
  ``kv_feats @ wv`` (projected here, before the kernel);
* optional global slot: ``logits = fc_gamma(q - k_glob)``, ``value = v_glob``;

then a per-channel softmax over the slots and ``sum softmax * value``,
before the residual and the BatchNorm.

The kernel (``csrc/attention.cu``) replaces the TPU kernel
``_attn_kernel``; see the note at the top of the source for what bounds it
on the card and how its design answers that.
"""

import ctypes
from typing import Optional

import torch

from nsdp_tpu_torch.ops import _build
from nsdp_tpu_torch.ops.gather import index_points

KMAX = 32  # most softmax slots (neighbours + global token) the kernel takes
DMAX = 256  # widest channel count the kernel takes


def mask_penalty(kv_mask: torch.Tensor) -> torch.Tensor:
    """Additive squared-distance penalty for masked kv points
    (``nsdp_tpu/ops/knn.py:21-30``).

    Finite 1e30 rather than inf: it keeps the selection's comparisons exact
    while dwarfing any real squared distance, so masked points sort after
    every selectable one.  ``(B, M)`` mask, nonzero = selectable.
    """
    return (kv_mask == 0).to(torch.float32) * 1e30


def _mlp2(x, w0, b0, w1, b1):
    return torch.relu(x @ w0 + b0) @ w1 + b1


def select_neighbours(xyz_q, kv_xyz, k: int, penalty=None) -> torch.Tensor:
    """(B, Nq, k) indices of the k nearest kv points, ascending, ties to the
    lowest index.  ``d2 = penalty + sum_c (x_q,c - x_kv,c)^2`` summed in
    that order, as the kernel does."""
    B, M = kv_xyz.shape[0], kv_xyz.shape[1]
    if penalty is None:
        penalty = torch.zeros((B, M), dtype=torch.float32, device=kv_xyz.device)
    d2 = penalty[:, None, :]
    for c in range(3):
        diff = xyz_q[:, :, None, c] - kv_xyz[:, None, :, c]
        d2 = d2 + diff * diff
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def fused_vector_attention_plain(
    xyz_q, kv_xyz, q_feats, K_a, V_a,
    delta_w0, delta_b0, delta_w1, delta_b1,
    gamma_w0, gamma_b0, gamma_w1, gamma_b1,
    k: int, k_glob=None, v_glob=None, penalty=None,
):
    """The attention in plain tensor ops; the (B, Nq, k, D) neighbourhood
    tensors are materialised.  ``k`` is already clamped to M."""
    idx = select_neighbours(xyz_q, kv_xyz, k, penalty)
    dx = xyz_q[:, :, None, :] - index_points(kv_xyz, idx)
    pos = _mlp2(dx, delta_w0, delta_b0, delta_w1, delta_b1)
    if q_feats is None:
        logits = _mlp2(pos, gamma_w0, gamma_b0, gamma_w1, gamma_b1)
        value = pos
    else:
        u = q_feats[:, :, None, :] - index_points(K_a, idx) + pos
        logits = _mlp2(u, gamma_w0, gamma_b0, gamma_w1, gamma_b1)
        value = index_points(V_a, idx) + pos
    if k_glob is not None:
        lg = _mlp2(q_feats - k_glob[:, None, :], gamma_w0, gamma_b0, gamma_w1, gamma_b1)
        logits = torch.cat([logits, lg[:, :, None, :]], dim=2)
        vg = v_glob[:, None, None, :].expand(-1, xyz_q.shape[1], 1, -1)
        value = torch.cat([value, vg], dim=2)
    m = logits.amax(dim=2, keepdim=True)
    e = torch.exp(logits - m)
    return (e * value).sum(dim=2) / e.sum(dim=2)


_SIGNATURES = {"nsdp_fused_attention": (ctypes.c_int, (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 14
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]
))}


def _launch(xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
            delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k, k_glob,
            v_glob, penalty):
    tensors = [t for t in (xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0,
                           delta_w1, delta_b1, gamma_w0, gamma_b0, gamma_w1,
                           gamma_b1, k_glob, v_glob, penalty) if t is not None]
    for t in tensors:
        if t.device != xyz_q.device:
            raise ValueError(f"attention operands on {t.device} and {xyz_q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"attention kernel takes float32, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the fused attention kernel is forward-only; run it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    B, Nq, M, D = xyz_q.shape[0], xyz_q.shape[1], kv_xyz.shape[1], delta_w1.shape[-1]
    shapes = {
        "xyz_q": (xyz_q, (B, Nq, 3)), "kv_xyz": (kv_xyz, (B, M, 3)),
        "q_feats": (q_feats, (B, Nq, D)), "K_a": (K_a, (B, M, D)), "V_a": (V_a, (B, M, D)),
        "delta_w0": (delta_w0, (3, D)), "delta_b0": (delta_b0, (D,)),
        "delta_w1": (delta_w1, (D, D)), "delta_b1": (delta_b1, (D,)),
        "gamma_w0": (gamma_w0, (D, D)), "gamma_b0": (gamma_b0, (D,)),
        "gamma_w1": (gamma_w1, (D, D)), "gamma_b1": (gamma_b1, (D,)),
        "k_glob": (k_glob, (B, D)), "v_glob": (v_glob, (B, D)), "kv_mask": (penalty, (B, M)),
    }
    for name, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"attention kernel: {name} has shape {tuple(t.shape)}, expected {want}")
    slots = k + (k_glob is not None)
    if D > DMAX or slots > KMAX:
        raise ValueError(
            f"attention kernel takes D <= {DMAX} and at most {KMAX} slots, got D={D}, {slots} slots"
        )
    out = torch.empty((B, Nq, D), dtype=torch.float32, device=xyz_q.device)
    if Nq == 0:
        return out
    idx = torch.empty((B, Nq, k), dtype=torch.int32, device=xyz_q.device)
    keep = []  # operands that must live until the C call returns

    def ptr(t):
        if t is None:
            return None
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    def linear(w):  # (in, out) -> nn.Linear's (out, in), contiguous
        return ptr(w.t())

    q_sb = q_sn = 0
    q_ptr = None
    if q_feats is not None:
        if q_feats.stride(-1) != 1:
            q_feats = q_feats.contiguous()
        keep.append(q_feats)  # strided: the decoder's broadcast query has q_sn == 0
        q_ptr, q_sb, q_sn = q_feats.data_ptr(), q_feats.stride(0), q_feats.stride(1)

    lib = _build.load("attention", _SIGNATURES)
    err = lib.nsdp_fused_attention(
        ptr(xyz_q), ptr(kv_xyz), ptr(penalty), q_ptr, q_sb, q_sn,
        ptr(K_a), ptr(V_a), ptr(k_glob), ptr(v_glob),
        linear(delta_w0), ptr(delta_b0), linear(delta_w1), ptr(delta_b1),
        linear(gamma_w0), ptr(gamma_b0), linear(gamma_w1), ptr(gamma_b1),
        idx.data_ptr(), out.data_ptr(), B, Nq, M, D, k, xyz_q.device.index or 0,
        _build.stream_of(xyz_q),
    )
    _build.check(lib, err, f"attention kernel (B={B}, Nq={Nq}, M={M}, D={D}, k={k})")
    fused_vector_attention.launches += 1
    return out


def fused_vector_attention(
    xyz_q: torch.Tensor,
    kv_xyz: torch.Tensor,
    q_feats: Optional[torch.Tensor],
    K_a: Optional[torch.Tensor],
    V_a: Optional[torch.Tensor],
    delta_w0, delta_b0, delta_w1, delta_b1,
    gamma_w0, gamma_b0, gamma_w1, gamma_b1,
    k: int,
    k_glob: Optional[torch.Tensor] = None,
    v_glob: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    kv_feats: Optional[torch.Tensor] = None,
    wk: Optional[torch.Tensor] = None,
    wv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused kNN vector attention (pre-residual, pre-norm).

    Args:
      xyz_q: (B, Nq, 3) query positions.
      kv_xyz: (B, M, 3) key/value positions (the kNN target set).
      q_feats: (B, Nq, D) projected query features (may be a broadcast
        view), or None for pos-only attention.
      K_a / V_a: (B, M, D) projected key/value features (None for pos-only
        and in projection mode).
      delta_* / gamma_*: fc_delta / fc_gamma weights, (in, out) layout.
      k: neighbours per query, clamped to M (includes the query itself when
        it is a kv point).
      k_glob / v_glob: optional (B, D) global-token key/value: an extra
        softmax slot with zero position encoding (requires q_feats).
      kv_mask: optional (B, M), nonzero = selectable.
      kv_feats / wk / wv: projection mode, ``K_a = kv_feats @ wk`` and
        ``V_a = kv_feats @ wv`` (replaces K_a/V_a; excludes the global
        token).

    Returns:
      (B, Nq, D) float32.  A CPU input runs the plain version; a CUDA input
      launches the kernel of ``csrc/attention.cu`` (counted in
      ``fused_vector_attention.launches``) or raises.
    """
    pos_only = q_feats is None
    if k_glob is not None and pos_only:
        raise ValueError("global token requires query features")
    if (k_glob is None) != (v_glob is None):
        raise ValueError("k_glob and v_glob go together")
    if kv_feats is not None:
        if wk is None or wv is None:
            raise ValueError("kv_feats requires wk and wv")
        if pos_only or K_a is not None or V_a is not None or k_glob is not None:
            raise ValueError(
                "projection mode replaces K_a/V_a and excludes the global token"
            )
        K_a, V_a = kv_feats @ wk, kv_feats @ wv
    elif not pos_only and (K_a is None or V_a is None):
        raise ValueError("featured attention needs K_a and V_a (or kv_feats)")
    k = min(k, kv_xyz.shape[1])
    penalty = None if kv_mask is None else mask_penalty(kv_mask)
    args = (xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
            delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k, k_glob,
            v_glob, penalty)
    if xyz_q.device.type == "cpu":
        return fused_vector_attention_plain(*args)
    if xyz_q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {xyz_q.device}")
    return _launch(*args)


fused_vector_attention.launches = 0
