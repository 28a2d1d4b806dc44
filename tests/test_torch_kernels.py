"""The port's CUDA kernels == their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

The input makers are shared with ``tests/test_torch_ops.py``, which holds
the plain versions against the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops import fps as port_fps
from nsdp_tpu_torch.ops import gather as port_gather
from nsdp_tpu_torch.ops import knn as port_knn


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _clouds(rng):
    base = rng.randn(2, 64, 3).astype(np.float32)
    skip = base.copy()
    skip[:, 5:20] = 0.0  # origin points: never picked, never update
    skip[1, 0] = 0.0  # index 0 is picked first even when invalid
    invalid = np.full((1, 16, 3), 1e-2, np.float32)  # |p|^2 = 3e-4 <= 1e-3
    return {"random": (base, 16), "origin_skip": (skip, 24), "all_invalid": (invalid, 6)}


def _weights(rng, d):
    """fc_delta / fc_gamma weights; the (d, d) ones scaled by 1/sqrt(d) so
    activations keep unit scale at every width."""
    shapes = [(3, d), (d,), (d, d), (d,), (d, d), (d,), (d, d), (d,)]
    inv = d ** -0.5
    scales = [0.3, 0.1, inv, 0.1, inv, 0.1, inv, 0.1]
    return [(rng.randn(*s) * c).astype(np.float32) for s, c in zip(shapes, scales)]


def _attention_case(rng, mode, masked, B=2, M=60, D=12, k=6, F=10, nq=25):
    """numpy arguments of one attention mode: ``(kwargs, weights)``."""
    kv = rng.randn(B, M, 3).astype(np.float32)
    if mode in ("pos_only", "table"):  # self-attention
        nq, xyz_q = M, kv
    elif mode == "proj":  # set-abstraction pattern: centres are kv points
        xyz_q = kv[:, :nq]
    else:  # decoder pattern: free query points
        xyz_q = rng.randn(B, nq, 3).astype(np.float32)
    a = dict(xyz_q=xyz_q, kv_xyz=kv, q_feats=None, K_a=None, V_a=None, k=k)
    if mode != "pos_only":
        a["q_feats"] = rng.randn(B, nq, D).astype(np.float32)
    if mode in ("table", "global"):
        a["K_a"] = rng.randn(B, M, D).astype(np.float32)
        a["V_a"] = rng.randn(B, M, D).astype(np.float32)
    if mode == "global":
        a["k_glob"] = rng.randn(B, D).astype(np.float32)
        a["v_glob"] = rng.randn(B, D).astype(np.float32)
    if mode == "proj":
        a["kv_feats"] = rng.randn(B, M, F).astype(np.float32)
        a["wk"] = (rng.randn(F, D) * 0.3).astype(np.float32)
        a["wv"] = (rng.randn(F, D) * 0.3).astype(np.float32)
    if masked:
        mask = (rng.rand(B, M) > 0.3).astype(np.float32)
        mask[:, :k] = 1.0  # at least k selectable points
        a["kv_mask"] = mask
    return a, _weights(rng, D)


FEATURES = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a", "k_glob", "v_glob", "kv_feats", "wk", "wv")
WEIGHTS = ("delta_w0", "delta_b0", "delta_w1", "delta_b1",
           "gamma_w0", "gamma_b0", "gamma_w1", "gamma_b1")
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # the JAX package's own (test_attention_pallas.py:244-246)


def _port_grads(a, w, G, device="cpu", dtype=torch.float32):
    """Gradients of sum(out * G) through the port's autograd function, by
    operand name, as numpy; and the kv_mask tensor (which must get none)."""
    leaf = lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=device, requires_grad=True)
    feats = {n: leaf(a[n]) for n in FEATURES if a.get(n) is not None}
    weights = [leaf(x) for x in w]
    mask = None if a.get("kv_mask") is None else leaf(a["kv_mask"])
    extra = {n: feats[n] for n in ("k_glob", "v_glob", "kv_feats", "wk", "wv") if n in feats}
    out = port_attention.fused_vector_attention(
        feats["xyz_q"], feats["kv_xyz"], feats.get("q_feats"), feats.get("K_a"),
        feats.get("V_a"), *weights, k=a["k"], kv_mask=mask, **extra)
    out.backward(torch.as_tensor(G, dtype=dtype, device=device))
    grads = {n: t.grad.cpu().numpy() for n, t in feats.items()}
    grads.update({n: t.grad.cpu().numpy() for n, t in zip(WEIGHTS, weights)})
    return grads, mask


def _assert_grads_close(got, ref):
    assert sorted(got) == sorted(ref)
    for name in ref:
        if name == "gamma_b1":  # analytically zero: a bias shared by all slots
            np.testing.assert_allclose(got[name], 0.0, atol=GRAD_TOL["atol"], err_msg=name)
            np.testing.assert_allclose(ref[name], 0.0, atol=GRAD_TOL["atol"], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], ref[name], **GRAD_TOL, err_msg=name)


def _port_attention(a, w, device="cpu"):
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    positional = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")
    kw = {key: t(v) for key, v in a.items() if key not in positional + ("k",)}
    return port_attention.fused_vector_attention(
        *[t(a[key]) for key in positional], *[t(x) for x in w], k=a["k"], **kw,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "origin_skip", "all_invalid"])
def test_fps_kernel_matches_plain(case, cuda, rng):
    xyz, npoint = _clouds(rng)[case]
    x = torch.from_numpy(xyz).to(cuda)
    before = port_fps.furthest_point_sample.launches
    got = port_fps.furthest_point_sample(x, npoint)
    torch.cuda.synchronize()
    assert port_fps.furthest_point_sample.launches == before + 1
    assert torch.equal(got.cpu(), port_fps.furthest_point_sample_plain(x, npoint).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [14496, 14497, 40962, port_fps.CLUSTER_POINTS,
                               port_fps.CLUSTER_POINTS + 1, 50000, 60000])
def test_fps_kernel_takes_any_cloud_size(n, cuda, rng):
    """Both sides of the shared-memory variant's size (14,496 points), a
    40,962-vertex mesh's size, both sides of the cluster variant's
    capacity, and clouds of 50,000 and 60,000 points, one launch each of
    the variant ``variant`` names (B = 2): a cloud with points at the origin
    and an all-invalid one (|p|^2 <= 1e-3 everywhere), index for index."""
    xyz = rng.randn(2, n, 3).astype(np.float32)
    xyz[0, 7:n:5] = 0.0
    xyz[1] = 1e-2
    x = torch.from_numpy(xyz).to(cuda)
    f = port_fps.furthest_point_sample
    kind = port_fps.variant(n)[0]
    before = (f.launches, f.cluster_launches, f.global_launches)
    got = f(x, 500)
    torch.cuda.synchronize()
    assert (f.launches, f.cluster_launches, f.global_launches) == (
        before[0] + 1, before[1] + (kind == "cluster"), before[2] + (kind == "global"))
    assert torch.equal(got, port_fps.furthest_point_sample_plain(x, 500))
    assert not got[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [14497, 40000, 60000])
def test_fps_cluster_ties_go_to_the_lowest_index(n, cuda, rng):
    """Ties between the blocks of a cluster: a cloud of two exact copies of
    one half (each pick ties with its copy, which lies in another block),
    and one far point copied on both sides of every range boundary; the
    lowest index wins, as in the plain version."""
    kind, c = port_fps.variant(n)
    assert kind == "cluster"
    half = rng.randn(1, n // 2, 3).astype(np.float32)
    tiled = np.concatenate([half, half, half[:, : n - 2 * (n // 2)]], 1)
    bounds = rng.randn(1, n, 3).astype(np.float32)
    per = -(-n // c)
    for r in range(1, c):
        bounds[0, r * per - 1] = bounds[0, r * per] = np.float32([40.0 + r, -30.0, 20.0 * r])
    x = torch.from_numpy(np.concatenate([tiled, bounds])).to(cuda)
    got = port_fps.furthest_point_sample(x, 500)
    torch.cuda.synchronize()
    assert torch.equal(got, port_fps.furthest_point_sample_plain(x, 500))
    assert (got[0] < n // 2).all()
    picked = set(got[1].tolist())
    for r in range(1, c):  # the lower copy of each boundary pair, never the upper
        assert r * per - 1 in picked and r * per not in picked


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["pos_only", "table", "proj", "global"])
def test_attention_kernel_matches_plain(mode, masked, cuda, rng):
    a, w = _attention_case(rng, mode, masked)
    with torch.inference_mode():
        before = port_attention.fused_vector_attention.launches
        got = _port_attention(a, w, cuda)
        torch.cuda.synchronize()
        assert port_attention.fused_vector_attention.launches == before + 1
        ref = _port_attention(a, w, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", ["pos_only", "table", "proj", "global", "broadcast"])
def test_attention_kernel_narrow_mode_matches_plain(mode, dtype, cuda, rng):
    """K1's narrow-operand mode (``compute_dtype``) against its plain
    version on the card: a relative L2 gap at most 1/4 of the plain narrow
    version's gap to float32 (the kernel's f32 sums meet the roundings in
    another order); the broadcast query takes ``attn_bcast_kernel``."""
    a, w = _attention_case(rng, "global" if mode == "broadcast" else mode, True,
                           B=2, M=120, D=40, k=7, nq=90)
    if mode == "broadcast":
        a["q_feats"] = np.broadcast_to(a["q_feats"][:, :1], a["q_feats"].shape)
    t = lambda x: None if x is None else torch.as_tensor(np.ascontiguousarray(x), device=cuda)
    named = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")
    args = [t(a[key]) for key in named] + [t(x) for x in w]
    if mode == "broadcast":
        args[2] = args[2][:, :1].expand(-1, a["xyz_q"].shape[1], -1)
    kw = {key: t(v) for key, v in a.items() if key not in named + ("k",)}
    f = port_attention.fused_vector_attention
    with torch.inference_mode():
        before = (f.launches, f.narrow_launches)
        got = f(*args, k=a["k"], compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert (f.launches, f.narrow_launches) == (before[0] + 1, before[1] + 1)
        cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
        ref = f(*map(cpu, args), k=a["k"], compute_dtype=dtype, **{k: cpu(v) for k, v in kw.items()})
        ref_f32 = f(*map(cpu, args), k=a["k"], **{k: cpu(v) for k, v in kw.items()})
    gap = _rel(ref, ref_f32)
    assert gap > 0 and _rel(got, ref) <= 0.25 * gap, (_rel(got, ref), gap)


def _narrow_against_plain(a, w, dtype, cuda, broadcast=False, share=0.25):
    """K1's narrow mode on the card against its plain version: one launch
    counted in both counters, a relative L2 gap at most ``share`` of the
    plain narrow version's gap to float32."""
    t = lambda x: None if x is None else torch.as_tensor(np.ascontiguousarray(x), device=cuda)
    named = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")
    args = [t(a[key]) for key in named] + [t(x) for x in w]
    if broadcast:
        args[2] = args[2][:, :1].expand(-1, a["xyz_q"].shape[1], -1)
    kw = {key: t(v) for key, v in a.items() if key not in named + ("k",)}
    f = port_attention.fused_vector_attention
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    with torch.inference_mode():
        before = (f.launches, f.narrow_launches)
        got = f(*args, k=a["k"], compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert (f.launches, f.narrow_launches) == (before[0] + 1, before[1] + 1)
        ref = f(*map(cpu, args), k=a["k"], compute_dtype=dtype, **{k: cpu(v) for k, v in kw.items()})
        ref_f32 = f(*map(cpu, args), k=a["k"], **{k: cpu(v) for k, v in kw.items()})
    assert torch.isfinite(got).all()
    gap = _rel(ref, ref_f32)
    assert gap > 0 and _rel(got, ref) <= share * gap, (_rel(got, ref), gap)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,D,k,dtype", [
    ("pos_only", 120, 10, torch.bfloat16), ("table", 120, 16, torch.bfloat16),
    ("table", 256, 16, torch.bfloat16), ("table", 256, 16, torch.float16),
    ("global", 200, 7, torch.bfloat16), ("global", 256, 16, torch.float16),
    ("broadcast", 200, 7, torch.bfloat16), ("broadcast", 200, 7, torch.float16),
    ("broadcast", 120, 10, torch.bfloat16), ("broadcast", 256, 16, torch.bfloat16),
])
def test_attention_kernel_narrow_mode_widths(mode, D, k, dtype, cuda, rng):
    """The narrow mode's tensor-core kernel at the shipped widths and
    neighbourhoods: with the global slot as a row of its query (S = k + 1,
    up to 17), or a broadcast query's global logits once per batch item."""
    a, w = _attention_case(rng, "global" if mode == "broadcast" else mode, False,
                           B=2, M=200, D=D, k=k, nq=150)
    _narrow_against_plain(a, w, dtype, cuda, broadcast=mode == "broadcast")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "m_is_k", "masked_begin", "odd_d"])
def test_attention_kernel_narrow_mode_edges(case, cuda, rng):
    """The engine's edges: a query count that is no multiple of a block's
    queries (37 = 4 x 9 + 1 at 64 rows and S = 7), as many kv points as
    neighbours, a masked 5000-point begin block (k = 10) and an odd width
    (D = 37: padded k-steps and n-tiles, one float per gather)."""
    if case == "ragged":
        a, w = _attention_case(rng, "global", False, B=2, M=100, D=200, k=7, nq=37)
        _narrow_against_plain(a, w, torch.bfloat16, cuda, broadcast=True)
    elif case == "m_is_k":
        a, w = _attention_case(rng, "table", False, B=2, M=16, D=120, k=16)
        _narrow_against_plain(a, w, torch.bfloat16, cuda)
    elif case == "masked_begin":
        a, w = _attention_case(rng, "pos_only", True, B=1, M=5000, D=120, k=10)
        _narrow_against_plain(a, w, torch.bfloat16, cuda)
    else:
        a, w = _attention_case(rng, "table", True, B=2, M=90, D=37, k=9, nq=50)
        _narrow_against_plain(a, w, torch.float16, cuda)


@pytest.mark.gpu
def test_narrow_shared_memory_mirror(cuda):
    """The narrow kernel's shared memory equals the wrapper's mirror of it,
    which the CPU tests hold under the card's 227 KB."""
    from nsdp_tpu_torch.ops import _build

    lib = _build.load("attention", port_attention._SIGNATURES)
    for D in (1, 12, 37, 40, 120, 200, 256):
        assert lib.nsdp_attention_narrow_smem(D) == port_attention.narrow_smem_bytes(D)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,D,k", [("pos_only", 120, 10), ("table", 256, 16),
                                      ("global", 200, 7), ("table", 64, 32)])
def test_attention_kernel_widths(mode, D, k, cuda, rng):
    """The register-tile widths (D up to 256) and neighbourhoods (k up to 32)."""
    a, w = _attention_case(rng, mode, True, B=1, M=300, D=D, k=k, nq=77)
    with torch.inference_mode():
        got = _port_attention(a, w, cuda)
        ref = _port_attention(a, w, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("D,k", [(200, 7), (120, 5), (36, 8), (256, 7), (130, 6)])
def test_attention_kernel_broadcast_query_gives_the_same_bits(D, k, cuda, rng):
    """The decoder's query is one row per batch item, broadcast over the
    queries (row stride 0): its global slot is computed once per batch item.
    The same query materialised row by row takes the per-row global slot;
    both give the same bits, at Nq = 77 (not a multiple of a block's
    queries) and at D = 130 (not a multiple of a thread's 4 channels)."""
    a, w = _attention_case(rng, "global", False, B=2, M=300, D=D, k=k, nq=77)
    q_row = torch.as_tensor(a["q_feats"][:, :1], device=cuda)
    t = lambda x: torch.as_tensor(x, device=cuda)
    args = [t(a[key]) for key in ("xyz_q", "kv_xyz")]
    rest = [t(a["K_a"]), t(a["V_a"]), *[t(x) for x in w]]
    kw = dict(k=k, k_glob=t(a["k_glob"]), v_glob=t(a["v_glob"]))
    with torch.inference_mode():
        bcast = q_row.expand(2, 77, D)
        assert bcast.stride(1) == 0
        got = port_attention.fused_vector_attention(*args, bcast, *rest, **kw)
        rows = port_attention.fused_vector_attention(*args, bcast.contiguous(), *rest, **kw)
        ref = port_attention.fused_vector_attention(
            *[x.cpu() for x in args], bcast.cpu(), *[x.cpu() for x in rest],
            k=k, k_glob=kw["k_glob"].cpu(), v_glob=kw["v_glob"].cpu())
    assert torch.equal(got, rows)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 16])
def test_attention_kernel_ties_go_to_the_lowest_index(k, cuda, rng):
    """Every kv point appears three times, so each selection breaks exact
    distance ties -- across the lanes and warps that share a query's scan."""
    a, w = _attention_case(rng, "table", False, B=1, M=150, D=16, k=k, nq=150)
    a["kv_xyz"] = np.tile(a["kv_xyz"][:, :50], (1, 3, 1))
    a["xyz_q"] = a["kv_xyz"]
    with torch.inference_mode():
        got = _port_attention(a, w, cuda)
        ref = _port_attention(a, w, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def _k2_against_plain(a, w, rng, cuda):
    G = rng.randn(a["xyz_q"].shape[0], a["xyz_q"].shape[1], w[2].shape[0]).astype(np.float32)
    before = (port_attention.fused_vector_attention.launches,
              port_attention.fused_vector_attention_backward.launches)
    got, mask = _port_grads(a, w, G, cuda)
    torch.cuda.synchronize()
    assert (port_attention.fused_vector_attention.launches,
            port_attention.fused_vector_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    ref, _ = _port_grads(a, w, G, "cpu")
    _assert_grads_close(got, ref)
    assert mask is None or mask.grad is None


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["pos_only", "table", "proj", "global"])
def test_attention_backward_kernel_matches_plain(mode, masked, cuda, rng):
    """K2 (one launch per backward) against its plain version on the CPU."""
    _k2_against_plain(*_attention_case(rng, mode, masked), rng, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,D,k", [("pos_only", 120, 10), ("table", 120, 16),
                                      ("global", 200, 7), ("table", 256, 16)])
def test_attention_backward_kernel_widths(mode, D, k, cuda, rng):
    """The training sites' widths (D = 120, 200, 256), masked."""
    a, w = _attention_case(rng, mode, True, B=2, M=300, D=D, k=k, nq=77)
    _k2_against_plain(a, w, rng, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,D,k,M,nq", [
    ("global", 36, 7, 300, 77), ("proj", 100, 16, 300, 51), ("pos_only", 130, 10, 301, 0),
    ("global", 130, 31, 300, 9), ("table", 64, 31, 300, 0), ("global", 200, 7, 300, 1),
    ("proj", 120, 16, 300, 1),
])
def test_attention_kernels_at_the_engines_edges(mode, D, k, M, nq, cuda, rng):
    """K1 and K2 where K2's tensor-core engine pads or runs short: D not a
    multiple of 8 (36, 100, 130), 32 slots (k = 31 and the global slot) or
    31, Nq = 1, and Nq not a multiple of the queries per block (77 of 4,
    51 of 2, 301 of 3)."""
    a, w = _attention_case(rng, mode, False, B=2, M=M, D=D, k=k, nq=nq)
    with torch.inference_mode():
        got = _port_attention(a, w, cuda)
        ref = _port_attention(a, w, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    _k2_against_plain(a, w, rng, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,D,k,M,nq", [
    ("table", 8, 10, 301, 0), ("global", 36, 7, 300, 77), ("pos_only", 120, 10, 301, 0),
    ("global", 130, 31, 300, 9), ("global", 200, 7, 300, 1), ("global", 200, 31, 300, 77),
    ("table", 256, 16, 301, 0), ("proj", 256, 10, 300, 1),
])
def test_attention_backward_kernel_row_tiles(mode, D, k, M, nq, cuda, rng):
    """K2's 64-row tiles at their edges, B = 2: every warpgroup width the
    row kernel is built for (D = 8, 36, 120, 130, 200, 256), slot counts
    that do not divide 64 (k = 10; k = 7 and k = 31 with the global slot),
    Nq = 1, and a ragged last tile (301 of 6 or 4 queries, 77 of 8, 9 of 2)."""
    a, w = _attention_case(rng, mode, False, B=2, M=M, D=D, k=k, nq=nq)
    _k2_against_plain(a, w, rng, cuda)


@pytest.mark.gpu
def test_backward_shared_memory_mirror(cuda):
    """K2's row kernel's shared memory equals the wrapper's mirror of it,
    which the CPU tests hold under the card's 227 KB."""
    from nsdp_tpu_torch.ops import _build

    lib = _build.load("attention_bwd", port_attention._SIGNATURES_BWD)
    for D in (1, 8, 12, 36, 37, 64, 100, 120, 128, 130, 200, 208, 256):
        assert lib.nsdp_attention_bwd_smem(D) == port_attention.backward_smem_bytes(D)


@pytest.mark.gpu
def test_attention_backward_ffma_masks_match_plain(cuda, rng):
    """The row kernel's fc_delta and fc_gamma ReLU masks, read from its
    workspace (the hidden rows it hands the weight gradients), equal the
    plain version's zero for zero at the decoder's shape (D = 200, k = 7
    and the global slot, M = 100 anchors), away from near-ties: entries
    whose float64 pre-activation lies within 1e-5 of zero, where float32
    rounding in another summation order may decide either way."""
    B, Nq, M, D, k = 2, 1000, 100, 200, 7
    a, w = _attention_case(rng, "global", False, B=B, M=M, D=D, k=k, nq=Nq)
    t = lambda x: torch.as_tensor(x, device=cuda)
    ops = [t(a[n]) for n in ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")] + [t(x) for x in w]
    ops += [t(a["k_glob"]), t(a["v_glob"])]
    idx = port_attention._launch(*ops[:13], k, ops[13], ops[14], None)[1]
    g = t(rng.randn(B, Nq, D).astype(np.float32))
    ws = torch.empty(port_attention.backward_workspace_floats(B, Nq, k, D, True),
                     dtype=torch.float32, device=cuda)
    port_attention._launch_bwd(*ops, idx, g, ws=ws)
    torch.cuda.synchronize()
    S, Dp = k + 1, port_attention.pad8(D)
    rows = ws[: 7 * B * Nq * S * Dp].view(7, B, Nq, S, Dp)[..., :D]
    hd_k, hg_k = rows[0], rows[4]  # the workspace's hd and hg arrays

    def hidden(dtype):
        xyz_q, kv, q, K, V, w0d, b0d, w1d, b1d, w0g, b0g = [x.to(dtype) for x in ops[:11]]
        k_glob = ops[13].to(dtype)
        gather = lambda x: torch.stack([x[b][idx[b].long()] for b in range(B)])
        dx = xyz_q[:, :, None] - gather(kv)
        hd_pre = dx @ w0d + b0d
        pos = torch.relu(hd_pre) @ w1d + b1d
        u = torch.cat([q[:, :, None] - gather(K) + pos, (q - k_glob[:, None])[:, :, None]], dim=2)
        hg_pre = u @ w0g + b0g
        hd_pre = torch.cat([hd_pre, torch.ones_like(hd_pre[:, :, :1])], dim=2)  # no global row
        return hd_pre, hg_pre

    h32, h64 = hidden(torch.float32), hidden(torch.float64)
    for name, got, pre32, pre64 in zip(("hd", "hg"), (hd_k, hg_k), h32, h64):
        if name == "hd":
            got, pre32, pre64 = got[:, :, :k], pre32[:, :, :k], pre64[:, :, :k]
        clear = pre64.abs() > 1e-5
        assert int(clear.sum()) > 0.99 * clear.numel(), name
        assert torch.equal((got > 0)[clear], (pre32 > 0)[clear]), name


@pytest.mark.gpu
def test_attention_backward_never_runs_plain_on_the_card(cuda, rng, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain backward ran on CUDA tensors")

    monkeypatch.setattr(port_attention, "fused_vector_attention_bwd_plain", refuse)
    a, w = _attention_case(rng, "global", False)
    G = rng.randn(*a["xyz_q"].shape[:2], w[2].shape[0]).astype(np.float32)
    before = port_attention.fused_vector_attention_backward.launches
    grads, _ = _port_grads(a, w, G, cuda)
    assert port_attention.fused_vector_attention_backward.launches == before + 1
    assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.gpu
@pytest.mark.parametrize("mode,D", [("pos_only", 120), ("global", 200), ("table", 256)])
def test_attention_kernel_reads_transposed_weights(mode, D, cuda, rng):
    """The modules pass ``nn.Linear`` weights as transposed views, which the
    kernel reads in place; (in, out) arrays give the same result."""
    a, w = _attention_case(rng, mode, False, B=1, M=300, D=D, k=10, nq=77)
    with torch.inference_mode():
        ref = _port_attention(a, w, cuda)
        views = [torch.as_tensor(np.ascontiguousarray(x.T), device=cuda).t()
                 if x.ndim == 2 else x for x in w]
        assert all(v.stride(0) == 1 for v in views if isinstance(v, torch.Tensor))
        got = _port_attention(a, views, cuda)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- K4 and the row gather


def _knn_case(rng, B, Nq, M, masked):
    kv = rng.randn(B, M, 3).astype(np.float32)
    q = rng.randn(B, Nq, 3).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(B, M) > 0.3).astype(np.float32)
        mask[:, :32] = 1.0
    return q, kv, mask


@pytest.mark.gpu
@pytest.mark.parametrize("B,Nq,M,k,masked", [
    (1, 500, 5000, 16, False), (8, 100, 500, 16, False), (2, 300, 3000, 10, True),
    (1, 77, 64, 7, False), (2, 40, 300, 32, True), (1, 200, 20000, 16, False),
])
def test_knn_kernel_matches_plain(B, Nq, M, k, masked, cuda, rng):
    """Indices and distances bit for bit, one launch per call; the last
    case streams a cloud larger than shared memory holds."""
    q, kv, mask = _knn_case(rng, B, Nq, M, masked)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)
    before = port_knn.knn.launches
    idx, d2 = port_knn.knn(t(q), t(kv), k, return_dist=True, kv_mask=t(mask))
    only_idx = port_knn.knn(t(q), t(kv), k, kv_mask=t(mask))
    torch.cuda.synchronize()
    assert port_knn.knn.launches == before + 2
    ref_idx, ref_d2 = port_knn.knn_plain(t(q), t(kv), k, return_dist=True, kv_mask=t(mask))
    assert idx.dtype == torch.int32 and torch.equal(idx, ref_idx) and torch.equal(only_idx, ref_idx)
    assert torch.equal(d2, ref_d2)


@pytest.mark.gpu
def test_knn_kernel_ties_go_to_the_lowest_index(cuda, rng):
    kv = np.tile(rng.randn(1, 50, 3).astype(np.float32), (1, 3, 1))
    x = torch.from_numpy(kv).to(cuda)
    got = port_knn.knn(x, x, 16)
    assert torch.equal(got, port_knn.knn_plain(x, x, 16))
    assert torch.equal(got[0, :50, :3], torch.arange(50, device=cuda)[:, None] + torch.tensor(
        [0, 50, 100], device=cuda, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiled", "k32", "masked_part"])
def test_knn_kernel_split_over_warps(case, cuda, rng):
    """K4 with several warps a query (500 queries of a 5000-point cloud,
    as at the set abstraction's first level), bit for bit: a cloud of 100
    tiled copies of 50 points, whose ties cross every part; k = 32; a mask
    over every point of part 0."""
    w = port_knn.split_warps(1, 500, 5000, torch.cuda.get_device_properties(0).multi_processor_count)
    assert w > 1
    kv = rng.randn(1, 5000, 3).astype(np.float32)
    if case == "tiled":
        kv = np.tile(kv[:, :50], (1, 100, 1))
    q = np.concatenate([kv[:, :250], rng.randn(1, 250, 3).astype(np.float32)], 1)
    mask = None
    if case == "masked_part":
        mask = ((np.arange(5000) // 32) % w != 0).astype(np.float32)[None]
    k = 32 if case in ("tiled", "k32") else 16
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    idx, d2 = port_knn.knn(t(q), t(kv), k, return_dist=True, kv_mask=t(mask))
    torch.cuda.synchronize()
    ref_idx, ref_d2 = port_knn.knn_plain(t(q), t(kv), k, return_dist=True, kv_mask=t(mask))
    assert torch.equal(idx, ref_idx) and torch.equal(d2, ref_d2)
    if case == "tiled":
        assert torch.equal(idx[0, :50], torch.arange(50, device=cuda)[:, None].int()
                           + 50 * torch.arange(32, device=cuda).int())


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 4, 8])
def test_knn_kernel_parts_of_fewer_than_k_points(w, cuda, rng):
    """W forced past the wrapper's choice on a 40-point cloud: part 1 holds
    8 points and the others none or 32, fewer than k = 16 in all but part
    0; their padding never wins, bit for bit against the plain version."""
    q = torch.from_numpy(rng.randn(2, 30, 3).astype(np.float32)).to(cuda)
    kv = torch.from_numpy(rng.randn(2, 40, 3).astype(np.float32)).to(cuda)
    idx, d2 = port_knn._launch(q, kv, 16, True, None, warps=w)
    torch.cuda.synchronize()
    ref_idx, ref_d2 = port_knn.knn_plain(q, kv, 16, return_dist=True)
    assert torch.equal(idx, ref_idx) and torch.equal(d2, ref_d2)


@pytest.mark.gpu
def test_knn_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 3, device=cuda)
    with pytest.raises(ValueError, match="k=9 > number of points 8"):
        port_knn.knn(x, x, 9)
    with pytest.raises(TypeError, match="float32"):
        port_knn.knn(x.double(), x.double(), 4)
    with pytest.raises(ValueError, match="k <= 32"):
        port_knn.knn(torch.zeros(1, 8, 3, device=cuda), torch.zeros(1, 40, 3, device=cuda), 33)
    with pytest.raises(ValueError, match="expected"):
        port_knn.knn(x, torch.zeros(2, 8, 3, device=cuda), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,W,S,k", [(1, 5000, 256, 500, 16), (2, 500, 256, 100, 16),
                                       (1, 5120, 256, 5120, 16), (2, 30, 6, 7, 5)])
def test_gather_kernel_matches_plain(B, M, W, S, k, cuda, rng):
    """Bit for bit, one launch; W = 6 takes the 4-byte copies."""
    table = torch.from_numpy(rng.randn(B, M, W).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, M, size=(B, S, k)).astype(np.int32)).to(cuda)
    before = port_gather.gather_rows.launches
    got = port_gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert port_gather.gather_rows.launches == before + 1
    assert got.shape == (B, S, k, W) and torch.equal(got, port_gather.gather_rows_plain(table, idx))


@pytest.mark.gpu
def test_gather_kernel_gradient_and_refusals(cuda, rng):
    table = torch.from_numpy(rng.randn(2, 40, 8).astype(np.float32)).to(cuda).requires_grad_()
    idx = torch.from_numpy(rng.randint(0, 40, size=(2, 6, 4)).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.randn(2, 6, 4, 8).astype(np.float32)).to(cuda)
    port_gather.gather_rows(table, idx).backward(g)
    ref = table.detach().cpu().requires_grad_()
    port_gather.gather_rows(ref, idx.cpu()).backward(g.cpu())
    torch.testing.assert_close(table.grad.cpu(), ref.grad, rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="float32"):
        port_gather.gather_rows(table.detach().double(), idx)
    with pytest.raises(TypeError, match="int32"):
        port_gather.gather_rows(table.detach(), idx.long())
