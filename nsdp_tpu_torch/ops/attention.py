"""Fused kNN vector attention: plain PyTorch version and the CUDA kernel's wrapper.

Counterpart of ``nsdp_tpu/ops/attention_pallas.py::fused_vector_attention``
(forward only), with the same arguments except the TPU-only ones (``tile``,
``interpret``, ``exact_self``, ``return_idx``, ``save_residuals``).  Weights
are (in, out) matrices, the JAX package's ``kernel`` layout, so the same
arrays feed both packages.  The kernel reads
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

The kernel (``csrc/attention.cu``, K1) replaces the TPU kernel
``_attn_kernel``; see the note at the top of the source for what bounds it
on the card and how its design answers that.  A query broadcast over a
batch item's queries (row stride 0, the decoder's) with a global slot and
``k <= 8`` takes the source's broadcast path, which computes the global
slot once per batch item.  Where a backward follows (an operand requires
grad: :class:`_FusedAttention`) the broadcast path runs its FFMA engine,
bit for bit the per-row path, which K2's recompute matches; where none
does (serving, sessions, ``predict``, validation) it runs its 3xTF32
tensor-core engine, float32-accurate but rounded otherwise
(:func:`k1_path`; ``fused_vector_attention.bcast_tc_launches`` counts it).

Gradients (counterpart of the custom VJPs ``knn_vector_attention`` and
``knn_vector_attention_proj``, ``attention_pallas.py:1086-1248``): when grad
mode is on and an operand requires grad, :func:`fused_vector_attention`
runs :class:`_FusedAttention`, whose forward keeps the (B, Nq, k) neighbour
indices and whose backward is the kernel of ``csrc/attention_bwd.cu`` (K2,
replacing ``_attn_bwd_kernel``) on the card, or
:func:`fused_vector_attention_bwd_plain` on the CPU.  The selection is a
constant of the backward: no gradient flows through the kNN, and
``kv_mask`` receives none.

Operands of a narrow type (a model of ``compute_dtype: bfloat16``) are
widened to float32 before the kernels, and each gradient goes back to its
operand's type (``attention_pallas.py:1236-1244``); the output is float32.

``compute_dtype`` (``torch.bfloat16`` / ``torch.float16``; or the
:func:`attention_dtype` context) is the TPU kernel's narrow-operand mode
(``attention_pallas.py:113-119,757-814``), which changes the numbers: each
MLP layer's input is rounded to the narrow type -- ``dx`` before
``fc_delta``, the hidden activations, ``fc_gamma``'s inputs (``q - k_n +
pos``, ``q - k_glob``) -- and so are the MLP weights, ``V_a`` and, in
projection mode, ``kv_feats``, ``wk`` and ``wv``; products accumulate in
float32 with float32 biases, and coordinates, distances, ``K_a``, the
global slot's ``k_glob``/``v_glob`` and the softmax stay float32.  The JAX
decoder (``exact_self=False``) rounds its split delta ``[x_q - hi | -lo]``
(``_split_w0``); the port rounds ``dx`` itself, so there the two agree to
tolerance, not bit for bit.  Forward only, as in JAX.  On the card the
mode has kernels of its own on the tensor cores (``csrc/rows_mma16.cuh``,
``attn_mma16_kernel``): 16-bit operands, exact products, float32 sums per
16-deep step, which are the TPU kernel's own; the host side of that engine
(fragment layout, row tiles, shared memory) is mirrored below.
"""

import contextlib
import ctypes
from contextvars import ContextVar
from typing import List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from nsdp_tpu_torch.ops import _build
from nsdp_tpu_torch.ops.gather import index_points
from nsdp_tpu_torch.ops.knn import mask_penalty, select

KMAX = 32  # most softmax slots (neighbours + global token) the kernel takes
DMAX = 256  # widest channel count the kernel takes
NARROW = {torch.bfloat16: 1, torch.float16: 2}  # the kernel's codes of the narrow modes
BCAST_TC_MODE = 3  # the kernel's code of float32 with the broadcast path on the tensor cores

# The narrow-operand mode of every attention in a context (None: float32),
# entered by ``models.deformation``'s ``predict(compute_dtype=...)`` so that
# it reaches each K1 site of the encoders and decoders, as
# ``make_fast_predict(compute_dtype=)`` reaches them in the JAX package.
_ATTENTION_DTYPE: ContextVar = ContextVar("nsdp_attention_dtype", default=None)


@contextlib.contextmanager
def attention_dtype(dtype):
    """Within this context :func:`fused_vector_attention` runs its
    narrow-operand mode in ``dtype`` (``torch.bfloat16``/``torch.float16``)
    unless a call names its own ``compute_dtype``."""
    if dtype is not None and dtype not in NARROW:
        raise ValueError(f"attention compute_dtype must be bfloat16 or float16, got {dtype}")
    token = _ATTENTION_DTYPE.set(dtype)
    try:
        yield
    finally:
        _ATTENTION_DTYPE.reset(token)


def _rounding(compute_dtype):
    """The narrow mode's rounding of an operand (kept in float32), or the
    identity."""
    if compute_dtype is None:
        return lambda t: t
    return lambda t: None if t is None else t.to(compute_dtype).float()


def kv_proj_profitable(m: int, f: int, d: int) -> bool:
    """Whether the JAX package projects a featured site's K/V inside its
    kernel (``attention_pallas.py:1251-1262``; its call sites,
    ``nsdp_tpu/nn/blocks.py:305-306,444-446``).  The port projects outside the
    kernel either way, but under a narrow compute dtype the choice decides
    the numbers (the in-kernel projection is float32, a ``Dense`` of the
    compute dtype is not), so the same rule is kept."""
    round_up = lambda x: -(-x // 128) * 128
    saved = round_up(8 + d) + round_up(d) - round_up(8 + f)
    return round_up(m) * saved >= 4 * f * d


def context_dtype() -> Optional[torch.dtype]:
    """The narrow-operand dtype of the enclosing :func:`attention_dtype`
    context, or None."""
    return _ATTENTION_DTYPE.get()


def _mlp2(x, w0, b0, w1, b1, rnd=lambda t: t):
    """Two-layer ReLU MLP; ``rnd`` rounds each layer's input (the narrow
    mode) or is the identity."""
    return rnd(torch.relu(rnd(x) @ w0 + b0)) @ w1 + b1


def fused_vector_attention_plain(
    xyz_q, kv_xyz, q_feats, K_a, V_a,
    delta_w0, delta_b0, delta_w1, delta_b1,
    gamma_w0, gamma_b0, gamma_w1, gamma_b1,
    k: int, k_glob=None, v_glob=None, penalty=None, idx=None, compute_dtype=None,
    round_values=True,
):
    """The attention in plain tensor ops; the (B, Nq, k, D) neighbourhood
    tensors are materialised.  ``k`` is already clamped to M.  The
    neighbours are K4's plain selection (``ops/knn.py::select``), which the
    kernel's ``knn_kernel`` computes too; a given ``idx`` (B, Nq, k)
    replaces it (``k`` and ``penalty`` are then unused).
    ``compute_dtype``: the narrow-operand mode (module docstring), each
    rounding a ``tensor.to(compute_dtype).float()``; ``round_values=False``
    leaves ``V_a`` as given (projection mode, where it is a float32 product
    of rounded operands)."""
    if idx is None:
        idx = select(xyz_q, kv_xyz, k, penalty)[0]
    rnd = _rounding(compute_dtype)
    delta_w0, delta_w1, gamma_w0, gamma_w1 = map(rnd, (delta_w0, delta_w1, gamma_w0, gamma_w1))
    if round_values:
        V_a = rnd(V_a)
    dx = xyz_q[:, :, None, :] - index_points(kv_xyz, idx)
    pos = _mlp2(dx, delta_w0, delta_b0, delta_w1, delta_b1, rnd)
    if q_feats is None:
        logits = _mlp2(pos, gamma_w0, gamma_b0, gamma_w1, gamma_b1, rnd)
        value = pos
    else:
        u = q_feats[:, :, None, :] - index_points(K_a, idx) + pos
        logits = _mlp2(u, gamma_w0, gamma_b0, gamma_w1, gamma_b1, rnd)
        value = index_points(V_a, idx) + pos
    if k_glob is not None:
        lg = _mlp2(q_feats - k_glob[:, None, :], gamma_w0, gamma_b0, gamma_w1, gamma_b1, rnd)
        logits = torch.cat([logits, lg[:, :, None, :]], dim=2)
        vg = v_glob[:, None, None, :].expand(-1, xyz_q.shape[1], 1, -1)
        value = torch.cat([value, vg], dim=2)
    m = logits.amax(dim=2, keepdim=True)
    e = torch.exp(logits - m)
    return (e * value).sum(dim=2) / e.sum(dim=2)


_SIGNATURES = {
    "nsdp_fused_attention": (ctypes.c_int, (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 17
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )),
    "nsdp_attention_bcast": (ctypes.c_int, [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]),
    "nsdp_attention_narrow_smem": (ctypes.c_longlong, [ctypes.c_int]),
    "nsdp_attention_bcast_tc_smem": (ctypes.c_longlong, [ctypes.c_int]),
    "nsdp_attention_bcast_tc_cols": (ctypes.c_int, [ctypes.c_int]),
}
_SIGNATURES_BWD = {
    "nsdp_fused_attention_bwd": (ctypes.c_int, (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 23
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )),
    "nsdp_attention_bwd_smem": (ctypes.c_longlong, [ctypes.c_int]),
    "nsdp_wgrad_smem": (ctypes.c_longlong, [ctypes.c_int]),
    "nsdp_wgrad_width": (ctypes.c_int, [ctypes.c_int]),
}


# ---- the tensor-core row-tile engine of K2 (csrc/rows_mma.cuh), host side

BWD_ROWS = 64  # (query, slot) rows of a block of K2's row kernel: one wgmma M


def pad8(D: int) -> int:
    """D rounded up to the engine's 8-wide tiles."""
    return -(-D // 8) * 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as the kernels' ``cvt.rna.tf32.f32``
    does: to nearest on the 13 low mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) TF32 parts of float32 ``x``: ``hi = tf32(x)``,
    ``lo = tf32(x - hi)``, as the engine splits every operand."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def row_groups(D: int) -> int:
    """Warpgroups of a block of K2's row kernel (``rows_mma.cuh::row_groups``):
    two up to D = 128, where two blocks share an SM, four above."""
    return 2 if pad8(D) <= 128 else 4


def wg_tiles(D: int) -> int:
    """n-tiles (8 columns) each warpgroup of the row kernel owns: its share
    of pad8(D)'s, rounded up to an instantiated width (``wg_tiles``)."""
    groups = row_groups(D)
    t = -(-(pad8(D) // 8) // groups)
    return next(w for w in ((4, 8) if groups == 2 else (7, 8)) if t <= w)


def tc_cols(D: int) -> int:
    """Columns of B the row kernel's warpgroups cover (``tc_cols``)."""
    return 8 * wg_tiles(D) * row_groups(D)


def backward_ring_stages(D: int) -> int:
    """Slots of the row kernel's weight ring (``rows_mma.cuh::ring_stages``)."""
    return 7 if (wg_tiles(D), row_groups(D)) == (7, 4) else 5


def weight_frags_plain(w: torch.Tensor, trans: bool, cols: Optional[int] = None) -> torch.Tensor:
    """A D x D (out, in) weight laid out as ``weight_frags_kernel`` writes
    it for the engine: the product's B operand (``B = w^T`` for ``x w^T``,
    ``B = w`` for ``dy w`` when ``trans``), zero-padded to pad8(D) x
    ``cols`` (K2's tc_cols(D) when None), split into its TF32 hi and lo
    parts, in wgmma's K-major order without swizzle, as (k-step, part,
    column group g, k-half h, row i, element x) float32 with ``[kc, q, g,
    h, i, x] = part q of B[8 kc + 4 h + x][8 g + i]``: per k-step and part,
    two 8 x 4 core matrices of 128 bytes per column group.  K1's
    tensor-core broadcast path lays out its three weights so
    (``weights_in_out_kernel<1>``, ``cols = bcast_tc_cols(D)``)."""
    D = w.shape[0]
    Dp, Np = pad8(D), tc_cols(D) if cols is None else cols
    B = torch.zeros((Dp, Np), dtype=torch.float32, device=w.device)
    B[:D, :D] = w if trans else w.t()
    parts = torch.stack(split_tf32(B))  # (2, Dp, Np)
    return parts.reshape(2, Dp // 8, 2, 4, Np // 8, 8).permute(1, 0, 4, 2, 5, 3).contiguous()


def weight_frag_floats(D: int) -> int:
    """Floats of one weight in the engine's order (``rows_mma.cuh::frag_floats``)."""
    return 2 * pad8(D) * tc_cols(D)


def backward_weight_floats(D: int) -> int:
    """Floats of K2's weight scratch: the four tensor-core products' weights
    in the engine's order and the two FFMA products' as pad8(D) x pad8(D)
    row-major ``B = w^T``."""
    return 4 * weight_frag_floats(D) + 2 * pad8(D) ** 2


def backward_tile_queries(slots: int) -> int:
    """Queries of a block of K2's row kernel: all slots of each."""
    return BWD_ROWS // slots


def backward_smem_bytes(D: int) -> int:
    """Shared memory of K2's row kernel (``attention_bwd.cu::rows_smem_bytes``):
    two activation buffers of 64 rows (pitch pad8(D) + 4), the weights' ring
    (per slot a k-step's tc_cols(D) x 8 floats, hi and lo, and an 8-byte
    mbarrier), and per row a 4-float position delta, a kv index and a
    workspace row."""
    act = 2 * BWD_ROWS * (pad8(D) + 4)
    ring = backward_ring_stages(D) * (16 * tc_cols(D) + 2)  # slots, and an mbarrier each
    return 4 * (act + ring + 4 * BWD_ROWS) + 8 * BWD_ROWS


# ---- K1's broadcast path on the tensor cores (csrc/attention.cu's
# attn_bcast_kernel<0, NW, NWG>, rows_mma.cuh's ring engine), host side

BCAST_KMAX = 8  # most neighbours of the broadcast path (nsdp_attention_bcast)
BCAST_TC_MAX_SLOTS = 8  # most ring slots of the tensor-core broadcast kernel
SM_SMEM = 233472  # shared memory of an sm_90 SM; a block reserves 1 KB of it


def bcast_path(has_glob: bool, q_sn: int, k: int) -> bool:
    """Whether a float32 call takes the broadcast path: a query broadcast
    over the batch item's queries (row stride 0) with a global slot and
    ``k <= 8`` (``attention.cu::nsdp_attention_bcast``)."""
    return bool(has_glob) and q_sn == 0 and k <= BCAST_KMAX


def k1_path(has_glob: bool, q_sn: int, k: int, compute_dtype=None,
            differentiable: bool = False) -> str:
    """The kernel a K1 call on the card runs: ``"narrow"`` (a narrow
    ``compute_dtype``: ``attn_mma16_kernel``), ``"bcast_tc"`` (a broadcast
    query that no backward follows: ``attn_bcast_kernel``'s 3xTF32
    tensor-core engine), ``"bcast"`` (a broadcast query in a differentiable
    call: its FFMA engine, whose bits K2's recompute matches) or ``"rows"``
    (``attn_kernel``)."""
    if compute_dtype is not None:
        return "narrow"
    if bcast_path(has_glob, q_sn, k):
        return "bcast" if differentiable else "bcast_tc"
    return "rows"


def bcast_tc_shape(D: int):
    """(NW, NWG) of the tensor-core broadcast kernel at width D
    (``attention.cu::tc_tiles``, ``tc_groups``): NWG warpgroups of NW
    n-tiles, covering pad8(D) with as little padding as its wgmma widths
    allow."""
    t = pad8(D) // 8
    if t <= 8:
        return 4, 2
    if t <= 16:
        return 8, 2
    if t <= 20:
        return 5, 4
    if t <= 25:
        return 5, 5
    return 8, 4


def bcast_tc_cols(D: int) -> int:
    """Columns Np of the kernel's weight layout (``tc_cols``)."""
    nw, nwg = bcast_tc_shape(D)
    return 8 * nw * nwg


def bcast_tc_weight_floats(D: int) -> int:
    """Floats of its weight scratch: three weights, hi and lo, pad8(D) x Np."""
    return 6 * pad8(D) * bcast_tc_cols(D)


def bcast_tc_slots(D: int) -> int:
    """Ring slots of the kernel (``tc_slots``): as many k-steps (16 Np
    floats and two mbarriers each) as its share of the SM leaves room for
    beside the rest, up to ``BCAST_TC_MAX_SLOTS``."""
    budget = SM_SMEM // 2 - 1024 if bcast_tc_shape(D)[1] == 2 else MAX_SMEM
    per = 64 * bcast_tc_cols(D) + 16
    return min(BCAST_TC_MAX_SLOTS, (budget - _bcast_tc_fixed_bytes(D)) // per)


def _bcast_tc_fixed_bytes(D: int) -> int:
    """The kernel's shared memory without the ring: 64 rows of activations
    (pitch pad8(D) + 4) and of values (``narrow_tile_pitch``), a 4-float
    position delta and a kv index per row, six pad8(D)-wide rows of
    per-column constants."""
    return 4 * 64 * (pad8(D) + 4 + narrow_tile_pitch(D) + 4) + 4 * 64 + 24 * pad8(D)


def bcast_tc_smem_bytes(D: int) -> int:
    """Shared memory of the tensor-core broadcast kernel
    (``attention.cu::bcast_tc_smem_bytes``)."""
    return _bcast_tc_fixed_bytes(D) + bcast_tc_slots(D) * (64 * bcast_tc_cols(D) + 16)


# ---- the 16-bit tensor-core engine of K1's narrow mode (csrc/rows_mma16.cuh),
# host side


NARROW_ROWS = 64  # (query, slot) rows of a block of the narrow kernel
NARROW_NT = 4  # n-tiles (8 columns) a warp
NARROW_STAGES = 4  # k-steps of weight fragments in flight
MAX_SMEM = 232448  # opt-in shared memory of an sm_90 block


def pad16(D: int) -> int:
    """D rounded up to the 16-deep k-steps of ``mma.m16n8k16``."""
    return -(-D // 16) * 16


def narrow_warps(D: int) -> int:
    """Warps of a block of the narrow kernel: ``NARROW_NT`` n-tiles each."""
    return -(-(pad8(D) // 8) // NARROW_NT)


def narrow_tile_pitch(D: int) -> int:
    """Row pitch (floats) of the kernel's f32 logits and values: pad8(D)
    moved to 8 or 24 mod 32, so a warp's C-fragment stores meet no bank
    conflict."""
    p = pad8(D)
    return p + 8 if p % 16 == 0 else p


def narrow_smem_bytes(D: int) -> int:
    """Shared memory of the narrow kernel (``rows_mma16.cuh::smem_bytes``):
    the 16-bit activations (pitch pad16(D) + 8) and the weight ring, which
    the f32 logits overlay after the products; the f32 values; a 4-float
    position delta and a neighbour index per row."""
    act = NARROW_ROWS * (pad16(D) + 8) * 2
    ring = narrow_warps(D) * NARROW_STAGES * NARROW_NT * 32 * 8
    tile = NARROW_ROWS * narrow_tile_pitch(D) * 4
    return max(act + ring, tile) + tile + NARROW_ROWS * 20


def weight_frag16_elems(D: int) -> int:
    """16-bit values of one weight in the narrow engine's fragment order."""
    return pad16(D) * pad8(D)


def weight_frags16_plain(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A D x D (out, in) weight as ``weight_frags16_kernel`` lays it out:
    ``B = w^T`` rounded to ``dtype`` and zero-padded to pad16(D) x pad8(D),
    as (k-step, n-tile, lane, 4) with ``[B[k0][n], B[k0 + 1][n],
    B[k0 + 8][n], B[k0 + 9][n]]``, ``k0 = 16 kc + 2 (l % 4)``,
    ``n = 8 nt + l // 4``: the two 32-bit B registers of ``mma.m16n8k16``
    for lane l."""
    D = w.shape[0]
    Kp, Np = pad16(D), pad8(D)
    B = torch.zeros((Kp, Np), dtype=dtype, device=w.device)
    B[:D, :D] = w.t().to(dtype)
    lane = torch.arange(32, device=w.device)
    k = 16 * torch.arange(Kp // 16, device=w.device)[:, None, None] + 2 * (lane % 4)
    n = 8 * torch.arange(Np // 8, device=w.device)[None, :, None] + lane // 4
    return torch.stack([B[k, n], B[k + 1, n], B[k + 8, n], B[k + 9, n]], dim=-1)


# ---- K2's weight-gradient reduction (csrc/attention_bwd.cu's wgrad_kernel),
# host side

WGRAD_ROWS = 32  # workspace rows of a staged chunk: four k-steps
WGRAD_COLS = 128  # Y columns of a block: two consumer warpgroups of 64
WGRAD_WIDTHS = (8, 11, 13)  # [X | 1] widths (8-column groups) the kernel is built for
WGRAD_MIN_ROWS = 256  # fewest rows of a row split


def wgrad_width(D: int) -> int:
    """[X | 1] width (8-column groups) of a block of K2's D-wide
    weight-gradient jobs (``attention_bwd.cu::wgrad_width``): of the built
    widths, the one that pads pad8(D + 1) least, the widest of equals."""
    groups = pad8(D + 1) // 8
    return min(reversed(WGRAD_WIDTHS), key=lambda nw: -(-groups // nw) * nw)


def _backward_tiles(D: int) -> List[Tuple[int, int, int, int]]:
    """The blocks of one row split of K2's weight-gradient reduction, in
    launch order, as (job, m0, n0, width): the transposed product Y^T [X | 1]
    at Y columns [m0, m0 + 128) by [X | 1] columns [n0, n0 + width); the
    three D-wide jobs (1-3) first, then [dx | 1] (job 0, width 8)."""
    width = 8 * wgrad_width(D)
    groups = range(0, D, WGRAD_COLS)
    heavy = [(q, m0, n0, width) for q in (1, 2, 3) for m0 in groups
             for n0 in range(0, pad8(D + 1), width)]
    return heavy + [(0, m0, 0, 8) for m0 in groups]


def _backward_splits(rows: int, D: int, sms: int) -> Tuple[int, int]:
    """Row splits of K2's weight-gradient reduction on a card of ``sms``
    SMs, (the D-wide jobs', [dx | 1]'s): one block an SM, one wave, the
    SMs shared as the blocks' work (a row of [dx | 1] takes ~3/5 of a
    D-wide block's time: the best of the splits timed on an H100 at the
    begin blocks, D = 120); each split at least 256 rows (but a lone one)."""
    tiles = _backward_tiles(D)
    light = sum(job == 0 for job, *_ in tiles)
    heavy = len(tiles) - light
    cap = max(1, rows // WGRAD_MIN_ROWS)
    splits = max(1, min(cap, 5 * sms // (5 * heavy + 3 * light)))
    return splits, max(1, min(cap, (sms - heavy * splits) // light))


def backward_partial_floats(splits: Tuple[int, int], D: int) -> int:
    """Floats of K2's weight-gradient partials: per row split a (D + 1, D)
    sum of each D-wide job, and a (4, D) sum of [dx | 1] per split of its."""
    s, s0 = splits
    return D * (3 * (D + 1) * s + 4 * s0)


def wgrad_smem_bytes(D: int) -> int:
    """Shared memory of K2's weight-gradient kernel (``WgradSmem``): four
    raw slots of 32 Y rows (pitch 136) and 32 X rows (pitch N), three split
    slots of 32 x N floats hi and lo, an 8-byte mbarrier per slot for each
    of full and empty, and the two consumer warpgroups' turns."""
    n = 8 * wgrad_width(D)
    return 4 * (4 * WGRAD_ROWS * (WGRAD_COLS + 8 + n) + 3 * WGRAD_ROWS * 2 * n) + (2 * (4 + 3) + 2) * 8


def wgrad_chunk_plain(x: torch.Tensor, n0: int, width: int) -> torch.Tensor:
    """A staged chunk of B = [X | 1] as K2's weight-gradient reduction lays
    it out for wgmma (``wgrad_split_chunk``): ``x`` holds the chunk's rows
    of X's live columns (up to 32 rows; the rows past them are zero); B's
    columns n0 .. n0 + width - 1 of [x | 1] (zeros past the ones), split
    into TF32 hi and lo, in :func:`weight_frags_plain`'s K-major order,
    (k-step, part, column group g, k-half h, column i, row e) with
    ``[kc, q, g, h, i, e] = part q of B[8 kc + 4 h + e][8 g + i]``."""
    rows, dx = x.shape
    B = torch.zeros((WGRAD_ROWS, max(n0 + width, dx + 1)), dtype=torch.float32, device=x.device)
    B[:rows, :dx] = x
    B[:rows, dx] = 1.0
    parts = torch.stack(split_tf32(B[:, n0:n0 + width].contiguous()))  # (2, 32, width)
    return parts.reshape(2, WGRAD_ROWS // 8, 2, 4, width // 8, 8).permute(1, 0, 4, 2, 5, 3).contiguous()


def _check_operands(xyz_q, kv_xyz, q_feats, K_a, V_a, weights, k, k_glob, v_glob,
                    penalty=None, g=None):
    """Raise unless the operands are what the kernels take; -> (B, Nq, M, D)."""
    tensors = [t for t in (xyz_q, kv_xyz, q_feats, K_a, V_a, *weights, k_glob, v_glob,
                           penalty, g) if t is not None]
    for t in tensors:
        if t.device != xyz_q.device:
            raise ValueError(f"attention operands on {t.device} and {xyz_q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"attention kernel takes float32, got {t.dtype}")
    B, Nq, M, D = xyz_q.shape[0], xyz_q.shape[1], kv_xyz.shape[1], weights[2].shape[-1]
    dw0, db0, dw1, db1, gw0, gb0, gw1, gb1 = weights
    shapes = {
        "xyz_q": (xyz_q, (B, Nq, 3)), "kv_xyz": (kv_xyz, (B, M, 3)),
        "q_feats": (q_feats, (B, Nq, D)), "K_a": (K_a, (B, M, D)), "V_a": (V_a, (B, M, D)),
        "delta_w0": (dw0, (3, D)), "delta_b0": (db0, (D,)),
        "delta_w1": (dw1, (D, D)), "delta_b1": (db1, (D,)),
        "gamma_w0": (gw0, (D, D)), "gamma_b0": (gb0, (D,)),
        "gamma_w1": (gw1, (D, D)), "gamma_b1": (gb1, (D,)),
        "k_glob": (k_glob, (B, D)), "v_glob": (v_glob, (B, D)), "kv_mask": (penalty, (B, M)),
        "g": (g, (B, Nq, D)),
    }
    for name, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"attention kernel: {name} has shape {tuple(t.shape)}, expected {want}")
    slots = k + (k_glob is not None)
    if D > DMAX or slots > KMAX:
        raise ValueError(
            f"attention kernel takes D <= {DMAX} and at most {KMAX} slots, got D={D}, {slots} slots"
        )
    return B, Nq, M, D


class _Pointers:
    """Raw device pointers for one C call; the tensors they point into live
    as long as this object."""

    def __init__(self):
        self.keep = []

    def __call__(self, t):
        if t is None:
            return None
        t = t.contiguous()
        self.keep.append(t)
        return t.data_ptr()

    def linear(self, w):
        """An (in, out) weight as nn.Linear's (out, in), contiguous: the
        modules' transposed views are read in place."""
        return self(w.t())

    def query(self, q):
        """(pointer, batch stride, row stride) of the query features: the
        decoder's broadcast query is read through its zero row stride."""
        if q is None:
            return None, 0, 0
        if q.stride(-1) != 1:
            q = q.contiguous()
        self.keep.append(q)
        return q.data_ptr(), q.stride(0), q.stride(1)


def _launch(xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
            delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k, k_glob,
            v_glob, penalty, compute_dtype=None, round_values=True, differentiable=False):
    """K1 on the card -> (out (B, Nq, D), idx (B, Nq, k) int32), by
    :func:`k1_path`.  The narrow mode runs the kernels of
    ``csrc/rows_mma16.cuh``'s tensor-core engine: they round the MLP
    weights (into fragment-order scratch allocated here) and ``V_a``
    themselves (not in projection mode, where ``V_a`` is a float32 product,
    as in the plain version).  A broadcast query runs its 3xTF32
    tensor-core engine unless ``differentiable`` (the forward of
    :class:`_FusedAttention`, whose output's bits K2's FFMA recompute must
    match), which keeps the FFMA engine."""
    weights = (delta_w0, delta_b0, delta_w1, delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1)
    B, Nq, M, D = _check_operands(xyz_q, kv_xyz, q_feats, K_a, V_a, weights, k,
                                  k_glob, v_glob, penalty)
    dev = xyz_q.device
    out = torch.empty((B, Nq, D), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Nq, k), dtype=torch.int32, device=dev)
    if Nq == 0:
        return out, idx
    ptr = _Pointers()
    q_ptr, q_sb, q_sn = ptr.query(q_feats)
    lib = _build.load("attention", _SIGNATURES)
    glog = wt = frag = None
    path = k1_path(k_glob is not None, q_sn, k, compute_dtype, differentiable)
    if path in ("bcast", "bcast_tc"):
        # the decoder's broadcast query: scratch for its global slot's
        # logits and the three D x D weights laid out for the engine (an
        # (in, out) copy; the tensor cores' split K-major order)
        glog = torch.empty((B, D), dtype=torch.float32, device=dev)
        shape = (bcast_tc_weight_floats(D),) if path == "bcast_tc" else (3, D, -(-D // 4) * 4)
        wt = torch.empty(shape, dtype=torch.float32, device=dev)
    elif path == "narrow":
        frag = torch.empty(3 * weight_frag16_elems(D), dtype=compute_dtype, device=dev)
        if k_glob is not None and q_sn == 0:  # a broadcast query's global logits, once
            glog = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = lib.nsdp_fused_attention(
        ptr(xyz_q), ptr(kv_xyz), ptr(penalty), q_ptr, q_sb, q_sn,
        ptr(K_a), ptr(V_a), ptr(k_glob), ptr(v_glob),
        ptr.linear(delta_w0), ptr(delta_b0), ptr.linear(delta_w1), ptr(delta_b1),
        ptr.linear(gamma_w0), ptr(gamma_b0), ptr.linear(gamma_w1), ptr(gamma_b1),
        idx.data_ptr(), out.data_ptr(), ptr(glog), ptr(wt), ptr(frag), B, Nq, M, D, k,
        BCAST_TC_MODE if path == "bcast_tc" else NARROW.get(compute_dtype, 0),
        int(compute_dtype is not None and round_values), dev.index or 0, _build.stream_of(xyz_q),
    )
    _build.check(lib, err, f"attention kernel (B={B}, Nq={Nq}, M={M}, D={D}, k={k})")
    fused_vector_attention.launches += 1
    if path == "narrow":
        fused_vector_attention.narrow_launches += 1
    elif path == "bcast_tc":
        fused_vector_attention.bcast_tc_launches += 1
    return out, idx


def backward_workspace_floats(B: int, Nq: int, k: int, D: int, has_global: bool) -> int:
    """Floats of K2's workspace: per (query, slot) row the seven operand
    rows of the weight gradients, pad8(D) wide, and the position delta,
    4 wide."""
    rows = B * Nq * (k + has_global)
    return rows * (7 * pad8(D) + 4)


def _launch_bwd(xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
                delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k_glob, v_glob,
                idx, g, ws=None):
    """K2 on the card: every operand's gradient, in the operands' order.
    ``ws``: the workspace to fill (``backward_workspace_floats`` float32 on
    the card), for a caller that reads the weight gradients' operand rows;
    allocated here when None."""
    weights = (delta_w0, delta_b0, delta_w1, delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1)
    k = idx.shape[-1]
    B, Nq, M, D = _check_operands(xyz_q, kv_xyz, q_feats, K_a, V_a, weights, k,
                                  k_glob, v_glob, g=g)
    if idx.dtype != torch.int32 or tuple(idx.shape) != (B, Nq, k) or idx.device != xyz_q.device:
        raise ValueError(f"attention backward: idx must be ({B}, {Nq}, {k}) int32 on {xyz_q.device}")
    if backward_smem_bytes(D) > MAX_SMEM:
        raise ValueError(f"attention backward: D={D} takes {backward_smem_bytes(D)} bytes of shared"
                         f" memory, more than a block's {MAX_SMEM}")
    f32 = dict(dtype=torch.float32, device=xyz_q.device)
    f64 = dict(dtype=torch.float64, device=xyz_q.device)
    featured, has_global = q_feats is not None, k_glob is not None
    dxyz_q = torch.zeros((B, Nq, 3), **f32)
    dq = torch.zeros((B, Nq, D), **f32) if featured else None
    # sums over many (query, slot) rows -- the kv scatters, the global
    # slot's sums over every query -- accumulate in float64
    dkv_xyz = torch.zeros((B, M, 3), **f64)
    dK = torch.zeros((B, M, D), **f64) if featured else None
    dV = torch.zeros((B, M, D), **f64) if featured else None
    dglob = torch.zeros((B, 2, D), **f64) if has_global else None
    # [ddw0 (3 rows) | ddb0 | ddw1 (D) | ddb1 | dgw0 (D) | dgb0 | dgw1 (D) | dgb1]
    wgrads = torch.zeros((3 * D + 7, D), **f32)
    rows = B * Nq * (k + has_global)
    if rows:
        sms = torch.cuda.get_device_properties(xyz_q.device).multi_processor_count
        splits = _backward_splits(rows, D, sms)
        wfrag = torch.empty(backward_weight_floats(D), **f32)
        n_ws = backward_workspace_floats(B, Nq, k, D, has_global)
        if ws is None:
            ws = torch.empty(n_ws, **f32)
        elif (ws.dtype != torch.float32 or ws.numel() < n_ws or ws.device != xyz_q.device
              or not ws.is_contiguous()):
            raise ValueError(f"attention backward: ws must hold {n_ws} contiguous float32 on"
                             f" {xyz_q.device}")
        partial = torch.empty(backward_partial_floats(splits, D), **f32)
        ptr = _Pointers()
        q_ptr, q_sb, q_sn = ptr.query(q_feats)
        lib = _build.load("attention_bwd", _SIGNATURES_BWD)
        err = lib.nsdp_fused_attention_bwd(
            ptr(xyz_q), ptr(kv_xyz), ptr(idx), q_ptr, q_sb, q_sn,
            ptr(K_a), ptr(V_a), ptr(k_glob), ptr(v_glob),
            ptr.linear(delta_w0), ptr(delta_b0), ptr.linear(delta_w1), ptr(delta_b1),
            ptr.linear(gamma_w0), ptr(gamma_b0), ptr.linear(gamma_w1), ptr(gamma_b1),
            ptr(g), dxyz_q.data_ptr(), dkv_xyz.data_ptr(), ptr(dq), ptr(dK), ptr(dV),
            ptr(dglob), wfrag.data_ptr(), ws.data_ptr(), partial.data_ptr(), wgrads.data_ptr(),
            B, Nq, M, D, k, *splits, xyz_q.device.index or 0, _build.stream_of(xyz_q),
        )
        _build.check(lib, err, f"attention backward kernel (B={B}, Nq={Nq}, M={M}, D={D}, k={k})")
        fused_vector_attention_backward.launches += 1
    e = 3 * D + 4
    single = lambda t: None if t is None else t.float()
    glob = (dglob[:, 0].float(), dglob[:, 1].float()) if has_global else (None, None)
    return (
        dxyz_q, single(dkv_xyz), dq, single(dK), single(dV),
        wgrads[0:3], wgrads[3], wgrads[4:D + 4], wgrads[D + 4],
        wgrads[D + 5:2 * D + 5], wgrads[2 * D + 5], wgrads[2 * D + 6:e + 2], wgrads[e + 2],
        *glob,
    )


def fused_vector_attention_bwd_plain(
    xyz_q, kv_xyz, q_feats, K_a, V_a,
    delta_w0, delta_b0, delta_w1, delta_b1,
    gamma_w0, gamma_b0, gamma_w1, gamma_b1,
    k_glob, v_glob, idx, g,
):
    """K2's plain version: autograd over :func:`fused_vector_attention_plain`
    with the selection fixed to ``idx``.  Returns the gradient of
    ``sum(out * g)`` with respect to each operand, in the operands' order
    (None for an operand that is None)."""
    operands = (xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
                delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k_glob, v_glob)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_() for t in operands]
        out = fused_vector_attention_plain(*leaves[:13], idx.shape[-1], leaves[13],
                                           leaves[14], idx=idx)
        live = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, live, g, allow_unused=True))
    result = []
    for t in leaves:
        grad = None if t is None else next(grads)
        if t is not None and grad is None:
            grad = torch.zeros_like(t)
        result.append(grad)
    return tuple(result)


def fused_vector_attention_backward(
    xyz_q, kv_xyz, q_feats, K_a, V_a,
    delta_w0, delta_b0, delta_w1, delta_b1,
    gamma_w0, gamma_b0, gamma_w1, gamma_b1,
    k_glob, v_glob, idx, g,
):
    """Gradients of the fused attention from its saved (B, Nq, k) ``idx``
    and the output gradient ``g`` (B, Nq, D), in the operands' order:
    ``(d xyz_q, d kv_xyz, d q_feats, d K_a, d V_a, 8 fc_delta/fc_gamma
    gradients in the (in, out) layout, d k_glob, d v_glob)``; None for an
    operand that is None.  A CPU input runs
    :func:`fused_vector_attention_bwd_plain`; a CUDA input launches the
    kernel of ``csrc/attention_bwd.cu`` (counted in
    ``fused_vector_attention_backward.launches``) or raises."""
    args = (xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
            delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k_glob, v_glob, idx, g)
    if xyz_q.device.type == "cpu":
        return fused_vector_attention_bwd_plain(*args)
    if xyz_q.device.type != "cuda":
        raise RuntimeError(f"no attention backward kernel for device {xyz_q.device}")
    return _launch_bwd(*args[:-1], g.contiguous())


fused_vector_attention_backward.launches = 0


class _FusedAttention(torch.autograd.Function):
    """The differentiable attention: K1 (or the plain version) forward,
    keeping the neighbour indices; K2 (or its plain version) backward."""

    @staticmethod
    def forward(ctx, xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
                delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k_glob, v_glob,
                penalty, k):
        args = (xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
                delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1)
        if xyz_q.device.type == "cuda":
            out, idx = _launch(*args, k, k_glob, v_glob, penalty, differentiable=True)
        else:
            idx = select(xyz_q, kv_xyz, k, penalty)[0]
            out = fused_vector_attention_plain(*args, k, k_glob, v_glob, idx=idx)
        ctx.save_for_backward(*args, k_glob, v_glob, idx)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grads = fused_vector_attention_backward(*ctx.saved_tensors, g)
        return (*grads, None, None)  # kv_mask's penalty and k take none


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
    compute_dtype: Optional[torch.dtype] = None,
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
      compute_dtype: ``torch.bfloat16`` or ``torch.float16`` for the
        narrow-operand mode (module docstring); None takes the
        :func:`attention_dtype` context's, float32 without one.  Raises
        with grad mode on: the mode has no backward.

    Returns:
      (B, Nq, D) float32 (narrow operands are widened first).  A CPU input
      runs the plain version; a CUDA input launches the kernel of
      ``csrc/attention.cu`` (counted in ``fused_vector_attention.launches``,
      a narrow mode's launch also in ``.narrow_launches``, the broadcast
      path's tensor-core engine also in ``.bcast_tc_launches``) or raises.
      ``fused_vector_attention.widened_bytes`` counts the bytes of the
      narrow operands widened to float32 (an expanded view by its
      elements, which the widening lays out whole), at the call, so a
      replay of a captured call adds nothing.
      With grad mode on and an operand that requires grad, the result is
      differentiable (module docstring); otherwise nothing is saved.
    """
    if compute_dtype is None:
        compute_dtype = _ATTENTION_DTYPE.get()
    if compute_dtype is not None:
        if compute_dtype not in NARROW:
            raise ValueError(
                f"attention compute_dtype must be bfloat16 or float16, got {compute_dtype}")
        if torch.is_grad_enabled():
            raise RuntimeError("the attention's narrow compute_dtype is inference only: "
                               "run it under torch.no_grad() or torch.inference_mode()")
    # a narrow model's activations, widened (autograd takes each gradient
    # back to its operand's type); the weights are float32 parameters
    narrow_operands = [t for t in (xyz_q, kv_xyz, q_feats, K_a, V_a, k_glob, v_glob, kv_feats)
                       if t is not None and t.dtype in NARROW]
    if narrow_operands:
        fused_vector_attention.widened_bytes += sum(t.numel() * t.element_size()
                                                    for t in narrow_operands)
        xyz_q, kv_xyz, q_feats, K_a, V_a, k_glob, v_glob, kv_feats = [
            t.float() if t is not None and t.dtype in NARROW else t
            for t in (xyz_q, kv_xyz, q_feats, K_a, V_a, k_glob, v_glob, kv_feats)]
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
        rnd = _rounding(compute_dtype)
        feats = rnd(kv_feats)
        K_a, V_a = feats @ rnd(wk), feats @ rnd(wv)
    elif not pos_only and (K_a is None or V_a is None):
        raise ValueError("featured attention needs K_a and V_a (or kv_feats)")
    k = min(k, kv_xyz.shape[1])
    penalty = None if kv_mask is None else mask_penalty(kv_mask)
    args = (xyz_q, kv_xyz, q_feats, K_a, V_a, delta_w0, delta_b0, delta_w1,
            delta_b1, gamma_w0, gamma_b0, gamma_w1, gamma_b1, k, k_glob,
            v_glob, penalty)
    if xyz_q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no attention kernel for device {xyz_q.device}")
    operands = [t for t in args if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _FusedAttention.apply(*args[:13], k_glob, v_glob, penalty, k)
    narrow = dict(compute_dtype=compute_dtype, round_values=kv_feats is None)
    if xyz_q.device.type == "cpu":
        return fused_vector_attention_plain(*args, **narrow)
    return _launch(*args, **narrow)[0]


fused_vector_attention.launches = 0
fused_vector_attention.narrow_launches = 0
fused_vector_attention.bcast_tc_launches = 0
fused_vector_attention.widened_bytes = 0
