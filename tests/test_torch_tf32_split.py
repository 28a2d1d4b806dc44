"""The arithmetic the tensor-core row-tile engine rests on, on the CPU.

K2 (``csrc/attention_bwd.cu``) runs four of its six D x D products through
``csrc/rows_mma.cuh``: 3xTF32 on ``wgmma.m64nNk8``.  An operand x splits
into ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna``: nearest on
the 13 low mantissa bits, ties away from zero), and each 8-deep k-step sums
``a_lo b_hi``, then ``a_hi b_lo``, then ``a_hi b_hi`` in a zeroed
accumulator that is then added to the running float32 sum.  Here that order
is emulated -- each mma's sum taken in float64 and rounded to float32 once
-- with the weight in the K-major order ``weight_frags_kernel`` writes
(``ops/attention.py::weight_frags_plain``), at the decoder's shapes, and
held against float64 beside the float32 product and a single TF32 product.
The wrapper's sizing helpers and the row kernel's shared-memory budget and
tiles are checked here too.
"""

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops.attention import pad8, split_tf32, tf32_round, weight_frags_plain


def _mlp_rows(D: int, seed: int) -> np.ndarray:
    """64 rows of ReLU-MLP activations, as the engine's blocks hold them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 3)
    h = np.maximum(x @ (rng.randn(3, D) * 0.5) + 0.1 * rng.randn(D), 0.0)
    h = h @ (rng.randn(D, D) / np.sqrt(D)) + 0.1 * rng.randn(D)
    return np.maximum(h, 0.0).astype(np.float32)


def _unpack(wfrag: torch.Tensor) -> torch.Tensor:
    """The hi and lo parts of the (pad8(D), tc_cols(D)) B operand, (2, pad8(D),
    tc_cols(D)), read back from the engine's order one core matrix at a time."""
    n_steps, groups = wfrag.shape[0], wfrag.shape[2]
    B = torch.zeros((2, 8 * n_steps, 8 * groups), dtype=torch.float32)
    for kc in range(n_steps):
        for q in range(2):
            for g in range(groups):
                for h in range(2):  # core matrix: 8 rows (n) x 4 elements (k)
                    k0, n0 = 8 * kc + 4 * h, 8 * g
                    B[q, k0:k0 + 4, n0:n0 + 8] = wfrag[kc, q, g, h].t()
    return B


def _engine_product(x: torch.Tensor, wfrag: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """x (rows, D) times the weight's B, as rows_mma computes it: per
    k-step ``a_lo b_hi``, ``a_hi b_lo``, ``a_hi b_hi`` into a zeroed
    accumulator, each mma rounded to float32 once, then added to the
    running sum (``terms = 1``: ``a_hi b_hi`` only, a single TF32
    product)."""
    Dp, Np = 8 * wfrag.shape[0], 8 * wfrag.shape[2]
    a = torch.zeros((x.shape[0], Dp), dtype=torch.float32)
    a[:, : x.shape[1]] = x
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = _unpack(wfrag)
    steps = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if terms == 3 else ((a_hi, b_hi),)
    acc = torch.zeros((x.shape[0], Np), dtype=torch.float32)
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
    """The weight in the engine's order holds the TF32 hi and lo parts of
    B = w^T (or w), padded with zeros to pad8(D) x tc_cols(D), as wgmma's
    K-major core matrices without swizzle: 8 columns of B (rows of the core
    matrix, 16 bytes apart) by 4 of its k, 128 bytes each, k-halves 128
    bytes apart and column groups 256 bytes apart; per k-step the hi part,
    then the lo part, one contiguous run."""
    rng = np.random.RandomState(D)
    w = torch.from_numpy(rng.randn(D, D).astype(np.float32))
    wfrag = weight_frags_plain(w, trans)
    Dp, Np = pad8(D), port_attention.tc_cols(D)
    assert Np >= Dp and Np % 16 == 0
    assert wfrag.shape == (Dp // 8, 2, Np // 8, 2, 8, 4)
    assert wfrag.numel() == port_attention.weight_frag_floats(D)
    B = torch.zeros((Dp, Np))
    B[:D, :D] = w if trans else w.t()
    hi, lo = split_tf32(B)
    parts = _unpack(wfrag)
    assert torch.equal(parts[0], hi) and torch.equal(parts[1], lo)
    # part q of B[8 kc + 4 h + x][8 g + i] at kc 16 Np + q 8 Np + g 64 + h 32 + i 4 + x
    flat = wfrag.reshape(-1)
    kc, g, h, i, x = 2, 3, 1, 5, 2  # B[22][29]
    for q, part in enumerate((hi, lo)):
        assert float(flat[kc * 16 * Np + q * 8 * Np + g * 64 + h * 32 + i * 4 + x]) == float(part[22, 29])


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


def test_row_tile_budget_and_tiles():
    """K2's row kernel at every width and slot count it takes: its shared
    memory (two 64-row activation buffers, the weights' ring, per-row
    scratch) under a block's 227 KB, two blocks of two warpgroups an SM up
    to D = 128 and one of four above, and the
    queries of a 64-row tile: all slots of each, as many as fit."""
    for D in range(1, 257):
        smem = port_attention.backward_smem_bytes(D)
        assert smem <= port_attention.MAX_SMEM, (D, smem)
        groups, wg = port_attention.row_groups(D), port_attention.wg_tiles(D)
        assert port_attention.tc_cols(D) == 8 * wg * groups >= pad8(D)
        assert (groups, wg in ((4, 8) if groups == 2 else (7, 8))) == (2 if D <= 128 else 4, True)
        if groups == 2:  # two blocks an SM
            assert 2 * (smem + 1024) <= 228 * 1024, (D, smem)
    # activations 2 x 64 x (pad8(D) + 4) floats, the ring's slots 16 tc_cols(D)
    # floats and an 8-byte mbarrier each (7 at D = 200, 5 at D = 256 and
    # 120), 1.5 KB per-row scratch
    assert port_attention.backward_smem_bytes(200) == 4 * (2 * 64 * 204 + 7 * (16 * 224 + 2) + 256) + 512
    assert port_attention.backward_smem_bytes(256) == 4 * (2 * 64 * 260 + 5 * (16 * 256 + 2) + 256) + 512
    assert port_attention.backward_smem_bytes(120) == 4 * (2 * 64 * 124 + 5 * (16 * 128 + 2) + 256) + 512
    for S in range(1, 33):
        tq = port_attention.backward_tile_queries(S)
        assert 1 <= tq and tq * S <= port_attention.BWD_ROWS < (tq + 1) * S, S
    # decoder (k 7 + the global slot), begin blocks (k 10), other encoder sites (k 16)
    assert [port_attention.backward_tile_queries(s) for s in (8, 10, 16)] == [8, 6, 4]
    assert port_attention.backward_weight_floats(200) == 4 * 2 * 200 * 224 + 2 * 200 * 200
