"""The port's kNN, gathers and geometry ops == the JAX package's, on the CPU.

The JAX side runs as its own tests run it here: ``knn_pallas`` (K4) and
``onehot_gather`` (P1) in interpret mode, ``knn_xla`` and the XLA geometry
ops.  The port runs its plain PyTorch versions (CPU tensors);
``tests/test_torch_kernels.py`` holds the CUDA kernels against those on the
card.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.ops import gather as jax_gather
from nsdp_tpu.ops import geometry as jax_geometry
from nsdp_tpu.ops.knn import knn_xla
from nsdp_tpu.ops.knn import square_distance as jax_square_distance
from nsdp_tpu.ops.knn_pallas import knn_pallas
from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops import gather as port_gather
from nsdp_tpu_torch.ops import geometry as port_geometry
from nsdp_tpu_torch.ops import knn as knn_module
from nsdp_tpu_torch.ops.knn import knn, knn_plain, square_distance

REPO = Path(__file__).resolve().parent.parent


def _probe_script():
    """``scripts/bench_gather_prefetch.py``, the TPU gather probes P1/P2."""
    spec = importlib.util.spec_from_file_location(
        "bench_gather_prefetch", REPO / "scripts" / "bench_gather_prefetch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- kNN (K4)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "kv_mask"])
@pytest.mark.parametrize("B,Nq,M,k", [(2, 300, 257, 7), (1, 129, 64, 10), (1, 40, 500, 16)])
def test_knn_plain_matches_knn_pallas(B, Nq, M, k, masked, rng):
    """Indices equal; distances within rtol 1e-6 (XLA on the CPU may
    contract the Pallas kernel's sum into FMAs, the port never does)."""
    q = rng.randn(B, Nq, 3).astype(np.float32)
    p = rng.randn(B, M, 3).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(B, M) > 0.3).astype(np.float32)
        mask[:, :k] = 1.0
    idx, d2 = knn_plain(_t(q), _t(p), k, return_dist=True,
                        kv_mask=None if mask is None else _t(mask))
    ref_idx, ref_d2 = knn_pallas(jnp.asarray(q), jnp.asarray(p), k, tile=128, return_dist=True,
                                 interpret=True,
                                 kv_mask=None if mask is None else jnp.asarray(mask))
    assert idx.dtype == torch.int32 and idx.shape == (B, Nq, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,Nq,M,k", [(2, 300, 257, 7), (1, 129, 64, 10)])
def test_knn_plain_matches_knn_xla(B, Nq, M, k, rng):
    """Equal indices on random inputs (the matmul identity of ``knn_xla``
    rounds otherwise, but moves no neighbour here)."""
    q = rng.randn(B, Nq, 3).astype(np.float32)
    p = rng.randn(B, M, 3).astype(np.float32)
    got = knn(_t(q), _t(p), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(knn_xla(jnp.asarray(q), jnp.asarray(p), k)))


def test_knn_prefix_mask_matches_knn_xla(rng):
    """A padded-partial cloud (``tests/test_partial_padded.py:42-46``): the
    padded rows never appear, and a query on the cloud finds itself first."""
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    mask = np.zeros((2, 64), np.float32)
    mask[0, :40] = 1.0
    mask[1, :25] = 1.0
    xyz = xyz * mask[..., None]
    got = knn(_t(xyz), _t(xyz), 6, kv_mask=_t(mask)).numpy()
    ref = np.asarray(knn_xla(jnp.asarray(xyz), jnp.asarray(xyz), 6, kv_mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(got, ref)
    assert got[0].max() < 40 and got[1].max() < 25
    np.testing.assert_array_equal(got[0, :40, 0], np.arange(40))


def test_knn_raises_when_k_exceeds_the_cloud(rng):
    p = _t(rng.randn(1, 5, 3).astype(np.float32))
    with pytest.raises(ValueError, match="k=6 > number of points 5"):
        knn(p, p, 6)
    with pytest.raises(ValueError):
        knn_xla(jnp.asarray(p.numpy()), jnp.asarray(p.numpy()), 6)
    with pytest.raises(RuntimeError, match="no knn kernel"):
        knn(torch.zeros(1, 4, 3, device="meta"), torch.zeros(1, 4, 3, device="meta"), 2)


def test_knn_and_the_attention_share_one_selection(rng):
    """The fused attention's plain version selects K4's plain neighbours:
    its output is the same with ``idx`` from :func:`knn`."""
    from tests.test_torch_kernels import _attention_case

    a, w = _attention_case(rng, "table", True)
    t = lambda x: _t(np.asarray(x))
    args = [t(a[key]) for key in ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")] + [t(x) for x in w]
    mask = t(a["kv_mask"])
    own = port_attention.fused_vector_attention_plain(
        *args, a["k"], penalty=port_attention.mask_penalty(mask))
    idx = knn(args[0], args[1], a["k"], kv_mask=mask)
    np.testing.assert_array_equal(
        port_attention.fused_vector_attention_plain(*args, a["k"], idx=idx).numpy(), own.numpy())


def test_square_distance_matches_jax(rng):
    a = rng.randn(2, 9, 3).astype(np.float32)
    b = rng.randn(2, 7, 3).astype(np.float32)
    np.testing.assert_allclose(square_distance(_t(a), _t(b)).numpy(),
                               np.asarray(jax_square_distance(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- gathers (P1/P2)


def test_gather_rows_matches_the_onehot_probe(rng):
    """The row gather == P1 (one-hot MXU gather, interpret mode) at the
    probe's shape, row for row through the slot-major layout of
    ``_flat_rowmajor``: exact."""
    probe = _probe_script()
    T, M, W, K = probe.T, probe.M, probe.W, probe.K
    table = rng.randn(M, W).astype(np.float32)
    idx = rng.randint(0, M, size=(1, T, K)).astype(np.int32)
    ref = np.asarray(probe.onehot_gather(jnp.asarray(table), jnp.asarray(idx[0]), tiles=1,
                                         interpret=True))
    got = port_gather.gather_rows(_t(table[None]), _t(idx))
    assert got.shape == (1, T, K, W)
    slot_major = got[0].transpose(0, 1).reshape(K * T, W).numpy()
    np.testing.assert_array_equal(slot_major, ref)
    np.testing.assert_array_equal(slot_major, table[probe._flat_rowmajor(idx)])


def test_gather_rows_gradient_matches_jax(rng):
    """The table's gradient (``index_add_``) == JAX's gradient of
    ``index_points``; repeated indices sum."""
    table = rng.randn(2, 12, 5).astype(np.float32)
    idx = rng.randint(0, 12, size=(2, 4, 6)).astype(np.int32)
    idx[0, 0, :3] = 3
    g = rng.randn(2, 4, 6, 5).astype(np.float32)
    t = _t(table).requires_grad_()
    out = port_gather.gather_rows(t, _t(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[np.arange(2)[:, None, None], idx])
    out.backward(_t(g))
    ref = jax.grad(lambda x: jnp.sum(jax_gather.index_points(x, jnp.asarray(idx)) * g))(
        jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="no gather kernel"):
        port_gather.gather_rows(torch.zeros(1, 4, 3, device="meta"), torch.zeros(1, 2, 2))


def test_gather_operation_matches_jax(rng):
    feats = rng.randn(2, 8, 12).astype(np.float32)
    idx = rng.randint(0, 12, size=(2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        port_gather.gather_operation(_t(feats), _t(idx)).numpy(),
        np.asarray(jax_gather.gather_operation(jnp.asarray(feats), jnp.asarray(idx))))


def test_grouping_operation_matches_jax(rng):
    feats = rng.randn(2, 8, 12).astype(np.float32)
    idx = rng.randint(0, 12, size=(2, 5, 3)).astype(np.int32)
    got = port_gather.grouping_operation(_t(feats), _t(idx))
    assert got.shape == (2, 8, 5, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_gather.grouping_operation(jnp.asarray(feats), jnp.asarray(idx))))


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("case", ["first_hit_padding", "no_hits", "random", "nsample_above_n"])
def test_ball_query_matches_jax(case, rng):
    if case == "first_hit_padding":
        xyz = np.array([[[0, 0, 0], [5, 5, 5], [0.1, 0, 0], [0.2, 0, 0]]], np.float32)
        centre, radius, nsample = np.zeros((1, 1, 3), np.float32), 0.5, 6
    elif case == "no_hits":
        xyz = np.array([[[5, 5, 5], [6, 6, 6]]], np.float32)
        centre, radius, nsample = np.zeros((1, 1, 3), np.float32), 0.5, 3
    elif case == "random":
        xyz = rng.randn(2, 64, 3).astype(np.float32)
        centre, radius, nsample = xyz[:, :16], 0.8, 9
    else:
        xyz = rng.randn(1, 5, 3).astype(np.float32)
        centre, radius, nsample = xyz[:, :2], 1.5, 8
    got = port_geometry.ball_query(radius, nsample, _t(xyz), _t(centre))
    ref = np.asarray(jax_geometry.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(centre)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "first_hit_padding":
        np.testing.assert_array_equal(got[0, 0].numpy(), [0, 2, 3, 0, 0, 0])


def test_three_nn_matches_jax(rng):
    unk = rng.randn(2, 9, 3).astype(np.float32)
    kno = rng.randn(2, 15, 3).astype(np.float32)
    dist, idx = port_geometry.three_nn(_t(unk), _t(kno))
    ref_d, ref_i = jax_geometry.three_nn(jnp.asarray(unk), jnp.asarray(kno))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-6)


def test_three_interpolate_and_weights_match_jax(rng):
    feats = rng.randn(2, 4, 6).astype(np.float32)
    idx = rng.randint(0, 6, size=(2, 5, 3)).astype(np.int32)
    dist = rng.rand(2, 5, 3).astype(np.float32)
    w = port_geometry.interpolation_weights(_t(dist))
    ref_w = jax_geometry.interpolation_weights(jnp.asarray(dist))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=1e-6, atol=1e-7)
    got = port_geometry.three_interpolate(_t(feats), _t(idx), w)
    ref = jax_geometry.three_interpolate(jnp.asarray(feats), jnp.asarray(idx), ref_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fibonacci_sphere_matches_jax():
    for n in (1, 7, 100):
        np.testing.assert_array_equal(port_geometry.fibonacci_sphere(n).numpy(),
                                      np.asarray(jax_geometry.fibonacci_sphere(n)))


def test_kernel_wrappers_refuse_before_building(rng):
    """What K4 and the gather kernel do not take raises in the wrapper,
    before anything is built or launched."""
    x = _t(rng.randn(1, 8, 3).astype(np.float32))
    with pytest.raises(ValueError, match="k=9 > number of points 8"):
        knn_module._launch(x, x, 9, False, None)
    with pytest.raises(TypeError, match="float32"):
        knn_module._launch(x.double(), x.double(), 4, False, None)
    with pytest.raises(ValueError, match="k <= 32"):
        knn_module._launch(x, _t(rng.randn(1, 40, 3).astype(np.float32)), 33, False, None)
    with pytest.raises(ValueError, match="kv_mask"):
        knn_module._launch(x, x, 4, False, torch.ones(1, 7))
    idx = torch.zeros(1, 2, 3, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        port_gather._launch(x, idx.long())
    with pytest.raises(TypeError, match="float32"):
        port_gather._launch(x.double(), idx)
    with pytest.raises(ValueError, match="expected"):
        port_gather._launch(x, idx[0])
