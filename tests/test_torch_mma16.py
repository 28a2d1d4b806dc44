"""The arithmetic and layout of K1's narrow mode on the tensor cores, on the CPU.

In the narrow-operand mode (``compute_dtype`` bfloat16 / float16) K1 runs
its D x D products on ``csrc/rows_mma16.cuh``: ``mma.sync.m16n8k16`` with
16-bit operands and float32 accumulators, each 16-deep k-step's exact
products summed into the running accumulator.  Here that product is
emulated in torch -- each k-step summed in float64 and rounded to float32
once -- with the weights read back from the fragment order
``weight_frags16_kernel`` writes (``ops/attention.py::weight_frags16_plain``,
read as the PTX ISA defines the m16n8k16 B registers) and the activations
from the ``ldmatrix`` addressing the engine uses.  The whole kernel is
emulated on top (its 3-wide first layer as float32 FMA chains, its rounding
points, a broadcast query's global logits once, the slot softmax in slot
order) and held

* against the JAX package's ``fused_vector_attention(compute_dtype=)`` in
  interpret mode, within ``tests/test_torch_dtype.py``'s limits: 1/4 of
  JAX's own narrow-vs-float32 gap at self sites, 3/4 at cross sites (where
  JAX rounds its split delta and the port ``dx`` itself);
* against the port's plain narrow version at the shipped widths by the
  rule the card is held to (``tests/test_torch_card.py``'s
  ``K1_NARROW_SHARE``): 1/4 of that version's gap to float32.

The kernel's tiling (whole queries in 64-row blocks) and the wrapper's
mirror of its shared memory are checked too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.ops.attention_pallas import fused_vector_attention as jax_attention
from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops.attention import pad8, pad16, weight_frags16_plain
from nsdp_tpu_torch.ops.gather import index_points
from nsdp_tpu_torch.ops.knn import mask_penalty, select
from tests.test_torch_kernels import _attention_case

JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _unpack16(frag: torch.Tensor) -> torch.Tensor:
    """The (pad16(D), pad8(D)) B operand as ``mma.m16n8k16`` reads it from
    the fragment order: lane l of k-step kc and n-tile nt holds
    ``b0 = (B[2t][g], B[2t + 1][g])`` and ``b1 = (B[2t + 8][g],
    B[2t + 9][g])`` of that 16 x 8 tile, t = l % 4, g = l // 4."""
    ks, nts = frag.shape[:2]
    B = torch.zeros((16 * ks, 8 * nts), dtype=frag.dtype)
    lane = torch.arange(32)
    for kc in range(ks):
        for nt in range(nts):
            k0, n = 16 * kc + 2 * (lane % 4), 8 * nt + lane // 4
            for i, dk in enumerate((0, 1, 8, 9)):
                B[k0 + dk, n] = frag[kc, nt, :, i]
    return B


def _ldmatrix_x4(act: torch.Tensor, mt: int, kc: int) -> torch.Tensor:
    """The four A registers (two 16-bit values each) of every lane as
    ``ldmatrix.x4`` loads them with the engine's addressing: lane a names
    row ``(a & 7) + ((a >> 3) & 1) * 8``, column ``(a >> 4) * 8`` of the
    16 x 16 tile for matrix a // 8, and lane l receives from matrix i the
    pair ``2 (l % 4)``, ``+ 1`` of that matrix's row l // 4 -> (32, 4, 2)."""
    regs = torch.zeros((32, 4, 2), dtype=act.dtype)
    for lane in range(32):
        for i in range(4):
            a = 8 * i + lane // 4
            row = 16 * mt + (a & 7) + ((a >> 3) & 1) * 8
            col = 16 * kc + (a >> 4) * 8 + 2 * (lane % 4)
            regs[lane, i] = act[row, col:col + 2]
    return regs


def _engine_product(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` ((in, out) weight) as the engine computes it: x rounded to
    ``dtype`` (the 16-bit store of the activations), B read back from the
    rounded weight's fragment order, and per 16-deep k-step the exact
    products summed into the float32 accumulator, rounded once."""
    D = w.shape[0]
    B = _unpack16(weight_frags16_plain(w.t(), dtype)).double()
    a = torch.zeros(x.shape[:-1] + (B.shape[0],), dtype=torch.float64)
    a[..., :D] = x.to(dtype).double()
    acc = torch.zeros(x.shape[:-1] + (B.shape[1],), dtype=torch.float32)
    for kc in range(B.shape[0] // 16):
        s = slice(16 * kc, 16 * kc + 16)
        acc = (acc.double() + a[..., s] @ B[s]).float()
    return acc[..., :D]


def _fma(a, b, c):
    """float32 fmaf: the product and sum exact (float64 here), rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_emulation(a, w, dtype, broadcast=False):
    """K1's narrow mode as ``attn_mma16_kernel`` computes it, on the numpy
    arguments of ``_attention_case``; ``broadcast``: the query features are
    one row per batch item, whose global logits ``glob_logits_kernel``
    computes once (float32 chains on the rounded operands)."""
    t = lambda x: None if x is None else torch.as_tensor(np.ascontiguousarray(x))
    xyz_q, kv, q, K, V = (t(a.get(n)) for n in ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a"))
    kg, vg = t(a.get("k_glob")), t(a.get("v_glob"))
    dw0, db0, dw1, db1, gw0, gb0, gw1, gb1 = (torch.as_tensor(x) for x in w)
    k = min(a["k"], kv.shape[1])
    penalty = None if a.get("kv_mask") is None else mask_penalty(t(a["kv_mask"]))
    idx = select(xyz_q, kv, k, penalty)[0]
    rnd = lambda x: x.to(dtype).float()
    dx, w0 = rnd(xyz_q[:, :, None] - index_points(kv, idx)), rnd(dw0)
    h = _fma(dx[..., 0:1], w0[0], _fma(dx[..., 1:2], w0[1], _fma(dx[..., 2:3], w0[2], db0)))
    pos = _engine_product(torch.relu(h), dw1, dtype) + db1
    gamma = lambda x: _engine_product(
        torch.relu(_engine_product(x, gw0, dtype) + gb0), gw1, dtype) + gb1
    if q is None:
        logits, value = gamma(pos), pos
    else:
        logits = gamma((q[:, :, None] - index_points(K, idx)) + pos)
        value = index_points(rnd(V), idx) + pos
    if kg is not None:
        if broadcast:  # once per batch item, float32 sums of the rounded operands
            hg = torch.relu(rnd(q[:, 0] - kg) @ rnd(gw0) + gb0)
            lg = (rnd(hg) @ rnd(gw1) + gb1)[:, None].expand(-1, q.shape[1], -1)
        else:  # the global slot's row through the engine
            lg = gamma(q - kg[:, None])
        logits = torch.cat([logits, lg[:, :, None]], dim=2)
        value = torch.cat([value, vg[:, None, None].expand(-1, q.shape[1], 1, -1)], dim=2)
    m = logits.amax(dim=2)
    se = o = torch.zeros_like(m)
    for s in range(logits.shape[2]):  # slot order, the global slot last
        ex = torch.exp(logits[:, :, s] - m)
        se, o = se + ex, _fma(ex, value[:, :, s], o)
    return o / se


# ---------------------------------------------------------------- the layout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [120, 200, 256, 37])
def test_weight_fragment_layout16(D, dtype):
    """The weight in fragment order holds ``B = w^T`` rounded to the narrow
    type and zero-padded to pad16(D) x pad8(D), where the m16n8k16 B
    registers read it."""
    rng = np.random.RandomState(D)
    w = torch.from_numpy(rng.randn(D, D).astype(np.float32))  # (out, in)
    frag = weight_frags16_plain(w, dtype)
    assert frag.shape == (pad16(D) // 16, pad8(D) // 8, 32, 4) and frag.dtype == dtype
    assert frag.numel() == port_attention.weight_frag16_elems(D)
    B = torch.zeros((pad16(D), pad8(D)), dtype=dtype)
    B[:D, :D] = w.t().to(dtype)
    assert torch.equal(_unpack16(frag), B)
    # lane 5 (g = 1, t = 1) of k-step 2, n-tile 3: column 25, rows 34, 35, 42, 43
    assert frag[2, 3, 5].tolist() == [float(B[r, 25]) for r in (34, 35, 42, 43)]


def test_ldmatrix_addressing_gives_the_a_fragments():
    """The engine's per-lane ldmatrix row addresses deliver the m16n8k16 A
    registers: a0 = A[g][2t, 2t+1], a1 = A[g+8][..], a2 = A[g][2t+8, 2t+9],
    a3 = A[g+8][2t+8, 2t+9] of each 16 x 16 tile."""
    act = torch.arange(32 * 48, dtype=torch.float32).reshape(32, 48)
    for mt in range(2):
        for kc in range(3):
            regs = _ldmatrix_x4(act, mt, kc)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                r, c = 16 * mt + g, 16 * kc + 2 * t
                want = [act[r, c:c + 2], act[r + 8, c:c + 2], act[r, c + 8:c + 10],
                        act[r + 8, c + 8:c + 10]]
                assert torch.equal(regs[lane], torch.stack(want))


# ---------------------------------------------------------------- the arithmetic


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_mma16_product_is_the_rounded_operands_product(dtype):
    """The engine's product is the exact product of the rounded operands
    to float32 accuracy (it sums per 16-deep k-step), as close to it in
    float64 as a float32 product of the rounded operands is."""
    rng = np.random.RandomState(3)
    D = 200
    x = torch.from_numpy(np.maximum(rng.randn(64, D), 0).astype(np.float32))
    w = torch.from_numpy((rng.randn(D, D) / np.sqrt(D)).astype(np.float32))
    exact = x.to(dtype).double() @ w.to(dtype).double()
    got = _engine_product(x, w, dtype)
    f32 = x.to(dtype).float() @ w.to(dtype).float()
    assert _rel(got, exact) <= 2 * max(_rel(f32, exact), 1e-7)
    assert _rel(got, x.double() @ w.double()) > 100 * _rel(got, exact)  # it is the narrow product


@pytest.mark.parametrize("mode,exact_self,dtype,D,k,bound", [
    ("pos_only", True, torch.bfloat16, 40, 7, 0.25),
    ("table", True, torch.bfloat16, 24, 4, 0.25),
    ("table", True, torch.float16, 40, 7, 0.25),
    ("global", False, torch.bfloat16, 40, 7, 0.75),
    ("global", False, torch.float16, 24, 4, 0.75),
])
def test_kernel_emulation_matches_jax(mode, exact_self, dtype, D, k, bound):
    """The emulated kernel against the TPU kernel's ``compute_dtype`` in
    interpret mode; the cross site with a broadcast query (the decoder's),
    its global logits once.  The port's float32 mode fails the limit."""
    rng = np.random.RandomState(D + k)
    nq = 64 if mode == "global" else 25
    a, w = _attention_case(rng, mode, False, B=1, M=64, D=D, k=k, nq=nq)
    if mode == "global":
        a["q_feats"] = np.ascontiguousarray(np.broadcast_to(a["q_feats"][:, :1], a["q_feats"].shape))
    j = lambda x: None if x is None else jnp.asarray(x)
    named = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")
    kw = {key: j(v) for key, v in a.items() if key not in named + ("k",)}
    run = lambda cd: np.asarray(jax_attention(
        *[j(a[key]) for key in named], *[j(x) for x in w], k=k, tile=128, interpret=True,
        exact_self=exact_self, compute_dtype=cd, **kw))
    f32, narrow = run(None), run(JAX_DTYPES[dtype])
    got = _kernel_emulation(a, w, dtype, broadcast=mode == "global")
    gap = _rel(narrow, f32)
    assert gap > 1e-4
    assert _rel(got, narrow) <= bound * gap, (_rel(got, narrow), gap)
    assert _rel(f32, narrow) > bound * gap


@pytest.mark.parametrize("mode,D,k,dtype", [
    ("pos_only", 120, 10, torch.bfloat16),
    ("table", 120, 16, torch.bfloat16),
    ("table", 256, 16, torch.bfloat16),
    ("table", 256, 16, torch.float16),
    ("broadcast", 200, 7, torch.bfloat16),
    ("broadcast", 200, 7, torch.float16),
    ("global", 200, 7, torch.bfloat16),
])
def test_kernel_emulation_holds_phase2_rule(mode, D, k, dtype):
    """At the shipped widths the emulated kernel is within 1/4 of the plain
    narrow version's gap to float32 (``tests/test_torch_card.py``'s
    ``K1_NARROW_SHARE``): the tensor cores' per-k-step sums are no worse a
    match for the plain version than the rule the card is held to."""
    rng = np.random.RandomState(D + k)
    a, w = _attention_case(rng, "global" if mode == "broadcast" else mode, mode == "table",
                           B=1, M=120, D=D, k=k, nq=40)
    if mode == "broadcast":
        a["q_feats"] = np.ascontiguousarray(np.broadcast_to(a["q_feats"][:, :1], a["q_feats"].shape))
    got = _kernel_emulation(a, w, dtype, broadcast=mode == "broadcast")
    t = lambda x: None if x is None else torch.as_tensor(x)
    named = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")
    kw = {key: t(v) for key, v in a.items() if key not in named + ("k",)}
    with torch.no_grad():
        plain = lambda cd: port_attention.fused_vector_attention(
            *[t(a[key]) for key in named], *[t(x) for x in w], k=k, compute_dtype=cd, **kw)
        ref, ref_f32 = plain(dtype), plain(None)
    gap = _rel(ref, ref_f32)
    assert gap > 1e-4 and _rel(got, ref) <= 0.25 * gap, (_rel(got, ref), gap)


# ---------------------------------------------------------------- the tiling


@pytest.mark.parametrize("S", [5, 8, 10, 11, 16, 17])
def test_narrow_tile_holds_whole_queries(S):
    """A block of the narrow kernel holds 64 // S whole queries, slot-major
    (row t S + s), and consecutive blocks take consecutive queries: every
    query's S rows lie in one block, each row once, and no block holds
    fewer rows than a query more would need."""
    rows = port_attention.NARROW_ROWS
    tq = rows // S
    assert rows == 64 and tq >= 2 and tq * S <= rows < (tq + 1) * S
    nq = 1000
    seen = []
    for blk in range(-(-nq // tq)):
        for r in range(tq * S):
            t, s = divmod(r, S)
            if blk * tq + t < nq:
                seen.append((blk * tq + t, s))
    assert sorted(seen) == [(n, s) for n in range(nq) for s in range(S)]


def test_narrow_tile_shared_memory():
    """A block's shared memory fits 227 KB at D = 256 (136,448 bytes), and
    two blocks fit an SM's 228 KB (1 KB reserved a block) up to D = 216:
    at the encoders' D = 120 and the decoder's D = 200."""
    smem = port_attention.narrow_smem_bytes
    assert smem(256) == 136448 <= port_attention.MAX_SMEM
    assert smem(200) == 108800 and smem(120) == 65792
    for d in (120, 200, 216):
        assert 2 * (smem(d) + 1024) <= 233472, d
    assert 2 * (smem(224) + 1024) > 233472
    assert [port_attention.narrow_warps(d) for d in (12, 40, 120, 200, 256)] == [1, 2, 4, 7, 8]
    assert [pad16(d) for d in (1, 16, 120, 200, 256)] == [16, 16, 128, 208, 256]
