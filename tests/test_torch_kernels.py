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


@pytest.mark.gpu
def test_attention_kernel_refuses_gradients(cuda, rng):
    a, w = _attention_case(rng, "pos_only", False)
    tw = [torch.as_tensor(x, device=cuda).requires_grad_() for x in w]
    xyz = torch.as_tensor(a["xyz_q"], device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        port_attention.fused_vector_attention(xyz, xyz, None, None, None, *tw, k=4)


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
