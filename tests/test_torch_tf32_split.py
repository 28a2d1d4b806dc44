"""The arithmetic the tensor-core row-block engine rests on, on the CPU.

K1 and K2 (``csrc/attention.cu``, ``csrc/attention_bwd.cu``) run every D x D
product through ``csrc/rows_mma.cuh``: 3xTF32 on ``mma.sync.m16n8k8``.
An operand x splits into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(``cvt.rna``: nearest on the 13 low mantissa bits, ties away from zero) as
its fragment is loaded, and each 8-deep k-step sums ``a_lo b_hi``, then
``a_hi b_lo``, then ``a_hi b_hi`` in a zeroed accumulator that is then
added to the running float32 sum.  Here that order is emulated -- each
mma's sum taken in float64 and rounded to float32 once -- with the weight
in the fragment order ``weight_frags_kernel`` writes
(``ops/attention.py::weight_frags_plain``), at the decoder's shapes, and
held against float64 beside the float32 product and a single TF32 product.
The wrapper's sizing helpers are checked here too.
"""

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops.attention import pad8, split_tf32, tf32_round, weight_frags_plain


def _mlp_rows(D: int, seed: int) -> np.ndarray:
    """32 rows of ReLU-MLP activations, as the engine's blocks hold them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(32, 3)
    h = np.maximum(x @ (rng.randn(3, D) * 0.5) + 0.1 * rng.randn(D), 0.0)
    h = h @ (rng.randn(D, D) / np.sqrt(D)) + 0.1 * rng.randn(D)
    return np.maximum(h, 0.0).astype(np.float32)


def _unpack(wfrag: torch.Tensor) -> torch.Tensor:
    """The (pad8(D), pad8(D)) B operand read back from its fragment order."""
    n_steps = wfrag.shape[0]
    B = torch.zeros((8 * n_steps, 8 * n_steps), dtype=torch.float32)
    lane = torch.arange(32)
    for kc in range(n_steps):
        for nt in range(n_steps):
            k, n = 8 * kc + lane % 4, 8 * nt + lane // 4
            B[k, n] = wfrag[kc, nt, :, 0]
            B[k + 4, n] = wfrag[kc, nt, :, 1]
    return B


def _engine_product(x: torch.Tensor, wfrag: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """x (rows, D) times the weight's B, as rows_mma computes it: per
    k-step ``a_lo b_hi``, ``a_hi b_lo``, ``a_hi b_hi`` into a zeroed
    accumulator, each mma rounded to float32 once, then added to the
    running sum (``terms = 1``: ``a_hi b_hi`` only, a single TF32
    product)."""
    Dp = 8 * wfrag.shape[0]
    a = torch.zeros((x.shape[0], Dp), dtype=torch.float32)
    a[:, : x.shape[1]] = x
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(_unpack(wfrag))
    steps = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if terms == 3 else ((a_hi, b_hi),)
    acc = torch.zeros((x.shape[0], Dp), dtype=torch.float32)
    for kc in range(Dp // 8):
        s = slice(8 * kc, 8 * kc + 8)
        step = torch.zeros_like(acc)
        for lhs, rhs in steps:
            step = (step.double() + lhs[:, s].double() @ rhs[s].double()).float()
        acc = acc + step
    return acc


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("D", [200, 256])
def test_3xtf32_product_is_as_accurate_as_float32(D, trans):
    """Within twice the float32 product's relative L2 error against float64;
    a single TF32 product is not (why the engine splits both operands)."""
    x = torch.from_numpy(_mlp_rows(D, seed=D + trans))
    rng = np.random.RandomState(7)
    w = torch.from_numpy((rng.randn(D, D) / np.sqrt(D)).astype(np.float32))  # (out, in)
    B = w if trans else w.t()
    ref = x.double() @ B.double()
    err_f32 = _rel(x @ B, ref)
    wfrag = weight_frags_plain(w, trans)
    err_3x = _rel(_engine_product(x, wfrag)[:, :D], ref)
    err_1x = _rel(_engine_product(x, wfrag, terms=1)[:, :D], ref)
    assert err_3x <= 2 * err_f32, (err_3x, err_f32)
    assert err_1x > 2 * err_f32, (err_1x, err_f32)
    assert err_1x > 100 * err_3x


def test_tf32_round_is_nearest_ties_away():
    """13 low mantissa bits cleared, the nearest TF32 value taken, a tie
    rounded away from zero (``cvt.rna``); x = hi + lo to 2^-22."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(10000) * 10.0 ** rng.uniform(-6, 6, 10000)).astype(np.float32))
    r = tf32_round(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11).double()  # TF32 ulp at |x|
    assert bool(((r.double() - x.double()).abs() <= ulp / 2).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11])
    assert tf32_round(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9]
    hi, lo = split_tf32(x)
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("D", [36, 130, 200])
def test_weight_fragment_layout(D, trans):
    """The weight in fragment order holds B = w^T (or w), padded with zeros
    to pad8(D), each of the engine's B fragments a contiguous float2."""
    rng = np.random.RandomState(D)
    w = torch.from_numpy(rng.randn(D, D).astype(np.float32))
    wfrag = weight_frags_plain(w, trans)
    Dp = pad8(D)
    assert wfrag.shape == (Dp // 8, Dp // 8, 32, 2)
    assert wfrag.numel() == port_attention.weight_frag_floats(D)
    B = torch.zeros((Dp, Dp))
    B[:D, :D] = w if trans else w.t()
    assert torch.equal(_unpack(wfrag), B)
    lane = 5  # group 1, thread 1 of k-step 2, n-tile 3: B[17][25] and B[21][25]
    assert wfrag[2, 3, lane].tolist() == [float(B[17, 25]), float(B[21, 25])]


def test_backward_sizing():
    """K2's scratch: the workspace (seven pad8(D)-wide operand rows and a
    4-wide position delta per (query, slot) row), the weight-gradient
    partials, and the row chunks, from the card's SM count."""
    assert [pad8(d) for d in (1, 8, 36, 120, 130, 200, 256)] == [8, 8, 40, 120, 136, 200, 256]
    assert port_attention.backward_workspace_floats(8, 5000, 7, 200, True) == 8 * 5000 * 8 * 1404
    assert port_attention.backward_workspace_floats(2, 10, 5, 36, False) == 2 * 10 * 5 * 284
    assert port_attention.backward_partial_floats(11, 200) == 11 * 607 * 200
    # decoder: 4 + 3 * 4 * 4 = 52 output tiles; two waves of 2 blocks per SM of 132
    assert port_attention._backward_tiles(200) == 52
    assert port_attention._backward_splits(8 * 5000 * 8, 200, 132) == 10
    assert port_attention._backward_splits(8 * 5000 * 8, 200, 114) == 8
    assert port_attention._backward_splits(8 * 5000 * 8, 120, 132) == 37  # 14 tiles
    assert port_attention._backward_splits(1000, 200, 132) == 4  # chunks of >= 256 rows
    assert port_attention._backward_splits(10, 120, 132) == 1
    assert port_attention._backward_tiles(256) == 4 + 3 * 5 * 4
