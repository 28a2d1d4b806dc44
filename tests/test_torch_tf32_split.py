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
tiles are checked here too.  K1's broadcast path runs the same arithmetic
where no backward follows (``attn_bcast_kernel``'s tensor-core engine, its
weights laid out at ``bcast_tc_cols(D)`` columns); its three products are
emulated the same way, inside the path.
"""

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops.attention import pad8, split_tf32, tf32_round, weight_frags_plain
from nsdp_tpu_torch.ops.knn import select


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
    # a split's partials: three (D + 1, D) sums and [dx | 1]'s (4, D) per split of its
    assert port_attention.backward_partial_floats((10, 6), 200) == 200 * (3 * 201 * 10 + 4 * 6)
    # decoder: two 128-column groups of Y by two 104-wide tiles of [X | 1], three
    # jobs, then [dx | 1]'s two blocks: 12 + 2 blocks a split, one an SM, the
    # SMs shared as the blocks' work (a [dx | 1] block's row ~3/5 of the others')
    assert len(port_attention._backward_tiles(200)) == 14
    assert port_attention._backward_splits(8 * 5000 * 8, 200, 132) == (10, 6)  # 120 + 12 blocks
    assert port_attention._backward_splits(8 * 5000 * 8, 200, 114) == (8, 9)
    assert port_attention._backward_splits(8 * 5000 * 10, 120, 132) == (20, 12)  # 6 + 1 blocks
    assert port_attention._backward_splits(1000, 200, 132) == (3, 3)  # splits of >= 256 rows
    assert port_attention._backward_splits(10, 120, 132) == (1, 1)
    assert len(port_attention._backward_tiles(256)) == 3 * 2 * 3 + 2  # 88-wide tiles of 257 columns


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


def test_weight_gradient_budget_and_tiles():
    """K2's weight-gradient reduction at every width: its blocks (Y^T [X | 1]
    tiles of 128 Y columns by a built [X | 1] width; 8 for [dx | 1]) cover
    each job's (Dx + 1) x D output once, so the (3 D + 7) x D one; its
    shared memory fits a block's 227 KB and leaves no room for a second
    block; and on an H100's 132 SMs its blocks take one wave and its
    partials stay under 6 MiB (before: 4.9 MB at the decoder, 6.5 MB at the
    begin blocks), each split at least 256 rows but a lone one."""
    for D in range(1, 257):
        nw = port_attention.wgrad_width(D)
        assert nw in port_attention.WGRAD_WIDTHS
        assert -(-pad8(D + 1) // (8 * nw)) * nw <= min(-(-pad8(D + 1) // (8 * w)) * w
                                                       for w in port_attention.WGRAD_WIDTHS)
        cover = [np.zeros((dx + 1, D), dtype=int) for dx in (3, D, D, D)]
        tiles = port_attention._backward_tiles(D)
        for job, m0, n0, width in tiles:
            assert width == (8 if job == 0 else 8 * nw) and m0 < D and n0 <= (3 if job == 0 else D)
            cover[job][n0:n0 + width, m0:m0 + port_attention.WGRAD_COLS] += 1
        assert all((c == 1).all() for c in cover), D
        assert [job for job, *_ in tiles] == sorted(job for job, *_ in tiles if job) + [0] * -(-D // 128)
        smem = port_attention.wgrad_smem_bytes(D)
        assert 228 * 1024 < 2 * (smem + 1024) and smem <= port_attention.MAX_SMEM, (D, smem)
        light = -(-D // 128)
        for rows in (1, 255, 300, 4096, 12800, 10 ** 6):
            splits, splits0 = port_attention._backward_splits(rows, D, 132)
            assert (len(tiles) - light) * splits + light * splits0 <= 132, (D, rows)
            assert 4 * port_attention.backward_partial_floats((splits, splits0), D) <= 6 * 2 ** 20
            for s in (splits, splits0):
                assert s == 1 or rows // s >= port_attention.WGRAD_MIN_ROWS, (D, rows, s)
    # 104 / 88 / 64 wide at the training sites' widths: no padding column
    assert [8 * port_attention.wgrad_width(d) for d in (200, 256, 120)] == [104, 88, 64]
    assert port_attention.wgrad_smem_bytes(200) == 4 * (4 * 32 * (136 + 104) + 3 * 32 * 208) + 128


def _unpack_chunk(chunk: torch.Tensor) -> torch.Tensor:
    """The hi and lo parts of a staged chunk's B, (2, 32, width), read back
    one core matrix at a time."""
    width = 8 * chunk.shape[2]
    B = torch.zeros((2, 32, width), dtype=torch.float32)
    for kc in range(4):
        for q in range(2):
            for g in range(width // 8):
                for h in range(2):
                    B[q, 8 * kc + 4 * h:8 * kc + 4 * h + 4, 8 * g:8 * g + 8] = chunk[kc, q, g, h].t()
    return B


@pytest.mark.parametrize("D,rows,n0", [(200, 32, 104), (200, 13, 0), (256, 32, 176), (3, 7, 0), (130, 1, 88)])
def test_weight_gradient_chunk_layout(D, rows, n0):
    """A staged chunk of B = [X | 1], as the reduction's splitting warps lay
    it out: the TF32 hi and lo parts of [X | 1]'s columns n0 .. n0 + width
    (ones after X's D, zeros beyond, rows past the chunk's zero), in wgmma's
    K-major core matrices without swizzle -- per k-step the hi part, then the
    lo part, each 8 columns (rows of a core matrix, 16 bytes apart) by 4 k,
    k-halves 128 bytes apart and column groups 256 bytes apart."""
    rng = np.random.RandomState(D + rows)
    x = torch.from_numpy(rng.randn(rows, D).astype(np.float32))
    width = 8 if D == 3 else 8 * port_attention.wgrad_width(D)
    chunk = port_attention.wgrad_chunk_plain(x, n0, width)
    assert chunk.shape == (4, 2, width // 8, 2, 8, 4)
    B = torch.zeros((32, n0 + width + D + 1))
    B[:rows, :D] = x
    B[:rows, D] = 1.0
    hi, lo = split_tf32(B[:, n0:n0 + width].contiguous())
    parts = _unpack_chunk(chunk)
    assert torch.equal(parts[0], hi) and torch.equal(parts[1], lo)
    # part q of B[8 kc + 4 h + e][8 g + i] at kc 16 N + q 8 N + g 64 + h 32 + i 4 + e
    flat = chunk.reshape(-1)
    kc, g, h, i, e = 2, width // 8 - 1, 1, 6, 3  # B[23][width - 2]
    for q, part in enumerate((hi, lo)):
        assert float(flat[kc * 16 * width + q * 8 * width + g * 64 + h * 32 + i * 4 + e]) == float(part[23, width - 2])


def _wgrad_emulated(X: torch.Tensor, Y: torch.Tensor, splits: int, terms: int = 3) -> torch.Tensor:
    """[X | 1]^T Y as the reduction computes it: per row split and 32-row
    chunk, Y^T [X | 1] by wgmma k-steps chained in the accumulator (a_lo
    b_hi, a_hi b_lo, a_hi b_hi per k-step, each product's sum rounded to
    float32 once; ``terms = 1``: a_hi b_hi alone), the chunks' sums added
    up apart 16 at a time and each 16's into the split's sum, then the
    splits' sums in order, compensated (wgrad_sum_kernel)."""
    R, D = X.shape
    per = -(-(-(-R // splits)) // 32) * 32
    kahan = lambda s, c, x: (lambda y: (lambda t: (t, (t - s) - y))(s + y))(x - c)
    total = comp_total = torch.zeros((D + 1, Y.shape[1]))
    for z in range(splits):
        s = part = torch.zeros((Y.shape[1], D + 1))
        rows = range(z * per, min(R, (z + 1) * per), 32)
        for i, r in enumerate(rows):
            chunk = port_attention.wgrad_chunk_plain(X[r:r + 32], 0, pad8(D + 1))
            b_hi, b_lo = _unpack_chunk(chunk)[:, :, :D + 1]
            a = torch.zeros((Y.shape[1], 32))
            a[:, :min(32, R - r)] = Y[r:r + 32].t()
            a_hi, a_lo = split_tf32(a)
            steps = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if terms == 3 else ((a_hi, b_hi),)
            acc = torch.zeros_like(s)
            for kc in range(4):
                k = slice(8 * kc, 8 * kc + 8)
                for lhs, rhs in steps:
                    acc = (acc.double() + lhs[:, k].double() @ rhs[k].double()).float()
            part = part + acc
            if i % 16 == 15 or i == len(rows) - 1:
                s, part = s + part, torch.zeros_like(part)
        total, comp_total = kahan(total, comp_total, s.t())
    return total


@pytest.mark.parametrize("D,R", [(200, 3000), (120, 2500), (256, 1100), (200, 30000)])
def test_weight_gradient_emulation_is_as_accurate_as_float32(D, R):
    """The reduction's arithmetic, emulated at the cells' widths over their
    row splits on 132 SMs (at R = 30,000, ~94 chunks a split), within twice
    the float32 product's relative L2 error against float64, [X | 1]^T Y
    with X ReLU activations and Y gradients; a single TF32 product is not
    (why both operands split)."""
    rng = np.random.RandomState(D)
    X = torch.from_numpy(np.concatenate([_mlp_rows(D, s) for s in range(-(-R // 64))])[:R])
    Y = torch.from_numpy(rng.randn(R, D).astype(np.float32))
    X1 = torch.cat([X, torch.ones((R, 1))], dim=1)
    ref = X1.double().t() @ Y.double()
    err_f32 = _rel(X1.t() @ Y, ref)
    splits = port_attention._backward_splits(R, D, 132)[0]
    assert splits > 1
    err_3x = _rel(_wgrad_emulated(X, Y, splits), ref)
    err_1x = _rel(_wgrad_emulated(X, Y, splits, terms=1), ref)
    assert err_3x <= 2 * err_f32, (err_3x, err_f32)
    assert err_1x > 2 * err_f32 and err_1x > 100 * err_3x, (err_1x, err_3x, err_f32)


@pytest.mark.parametrize("D", [36, 130, 200])
def test_broadcast_path_weight_layout(D):
    """K1's tensor-core broadcast path lays out B = w^T at its own column
    count (``bcast_tc_cols``; no padding at D = 200), in the engine's order."""
    rng = np.random.RandomState(D + 1)
    w = torch.from_numpy(rng.randn(D, D).astype(np.float32))
    Np = port_attention.bcast_tc_cols(D)
    wfrag = weight_frags_plain(w, False, Np)
    assert wfrag.shape == (pad8(D) // 8, 2, Np // 8, 2, 8, 4)
    assert 3 * wfrag.numel() == port_attention.bcast_tc_weight_floats(D)
    B = torch.zeros((pad8(D), Np))
    B[:D, :D] = w.t()
    hi, lo = split_tf32(B)
    parts = _unpack(wfrag)
    assert torch.equal(parts[0], hi) and torch.equal(parts[1], lo)


def _bcast_tc_emulated(xyz_q, kv_xyz, q_row, K, V, w, k_glob, v_glob, idx):
    """K1's broadcast path as its tensor-core kernel computes it (batch of
    one): fc_delta's first layer, the slot softmax and the global slot's
    logits in float32, the three D x D products by ``_engine_product`` on
    the weights at ``bcast_tc_cols(D)`` columns."""
    dw0, db0, dw1, db1, gw0, gb0, gw1, gb1 = w  # (in, out)
    D, k = dw1.shape[0], idx.shape[-1]
    Np = port_attention.bcast_tc_cols(D)
    product = lambda x, wi: _engine_product(x, weight_frags_plain(wi.t().contiguous(), False, Np))[:, :D]
    n = idx[0].reshape(-1)
    dx = (xyz_q[0][:, None, :] - kv_xyz[0][idx[0]]).reshape(-1, 3)
    pos = product(torch.relu(dx @ dw0 + db0), dw1) + db1
    u = (q_row[0, 0] - K[0][n]) + pos
    value = (V[0][n] + pos).reshape(-1, k, D)
    logits = (product(torch.relu(product(u, gw0) + gb0), gw1) + gb1).reshape(-1, k, D)
    lg = torch.relu((q_row[0, 0] - k_glob[0]) @ gw0 + gb0) @ gw1 + gb1
    logits = torch.cat([logits, lg.expand(logits.shape[0], 1, D)], 1)
    value = torch.cat([value, v_glob[0].expand(value.shape[0], 1, D)], 1)
    e = torch.exp(logits - logits.amax(1, keepdim=True))
    return ((e * value).sum(1) / e.sum(1))[None]


@pytest.mark.parametrize("D,k", [(200, 7), (130, 6), (36, 8), (256, 7), (120, 5)])
def test_broadcast_path_emulation_is_as_accurate_as_float32(D, k):
    """The tensor-core broadcast path, emulated, within twice the plain
    float32 version's relative L2 gap to float64 (the rule its kernel is
    held to on the card, ``tests/test_torch_kernels.py``)."""
    rng = np.random.RandomState(D * 10 + k)
    t = lambda *s, c=1.0: torch.from_numpy((rng.randn(*s) * c).astype(np.float32))
    nq, M, inv = 30, 60, D ** -0.5
    xyz_q, kv_xyz, q_row, K, V = t(1, nq, 3), t(1, M, 3), t(1, 1, D), t(1, M, D), t(1, M, D)
    w = [t(3, D, c=0.3), t(D, c=0.1), t(D, D, c=inv), t(D, c=0.1), t(D, D, c=inv), t(D, c=0.1),
         t(D, D, c=inv), t(D, c=0.1)]
    k_glob, v_glob = t(1, D), t(1, D)
    idx = select(xyz_q, kv_xyz, k)[0]
    q = q_row.expand(1, nq, D)
    ops = (xyz_q, kv_xyz, q, K, V, *w)
    plain = lambda cast: port_attention.fused_vector_attention_plain(
        *[cast(x) for x in ops], k, cast(k_glob), cast(v_glob), idx=idx)
    ref = plain(lambda x: x.double())
    gap_f32 = _rel(plain(lambda x: x), ref)
    gap_tc = _rel(_bcast_tc_emulated(xyz_q, kv_xyz, q_row, K, V, w, k_glob, v_glob, idx), ref)
    assert gap_f32 > 0 and gap_tc <= 2 * gap_f32, (gap_tc, gap_f32)
