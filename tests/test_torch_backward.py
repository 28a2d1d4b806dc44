"""The port's attention gradients and train-mode BatchNorm == the JAX
package's, on the CPU.

The JAX side runs its custom VJPs (``knn_vector_attention`` and
``knn_vector_attention_proj``) with the Pallas kernels in interpret mode;
the port runs its autograd function on CPU tensors, i.e. K1's and K2's plain
versions.  ``tests/test_torch_kernels.py`` holds K2 against its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.nn.blocks import BatchNorm as JaxBatchNorm
from nsdp_tpu.ops.attention_pallas import knn_vector_attention, knn_vector_attention_proj
from nsdp_tpu_torch.nn.blocks import BatchNorm
from nsdp_tpu_torch.ops import attention as port_attention
from tests.test_torch_kernels import (
    FEATURES,
    WEIGHTS,
    _assert_grads_close,
    _attention_case,
    _port_grads,
)


def _jax_grads(a, w, G):
    """Gradients of sum(out * G) through the JAX custom VJP, by name."""
    feats = {n: jnp.asarray(a[n]) for n in FEATURES if a.get(n) is not None}
    mask = None if a.get("kv_mask") is None else jnp.asarray(a["kv_mask"])

    def loss(f, ws):
        if "kv_feats" in f:
            out = knn_vector_attention_proj(
                f["xyz_q"], f["kv_xyz"], f["q_feats"], f["kv_feats"], f["wk"], f["wv"],
                mask, *ws, a["k"], 128, True)
        else:
            out = knn_vector_attention(
                f["xyz_q"], f["kv_xyz"], f.get("q_feats"), f.get("K_a"), f.get("V_a"),
                f.get("k_glob"), f.get("v_glob"), mask, *ws, a["k"], 128, True)
        return jnp.sum(out * G)

    gf, gw = jax.grad(loss, argnums=(0, 1))(feats, [jnp.asarray(x) for x in w])
    return {**{n: np.asarray(v) for n, v in gf.items()},
            **{n: np.asarray(v) for n, v in zip(WEIGHTS, gw)}}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["pos_only", "table", "proj", "global"])
def test_attention_gradients_match_jax(mode, masked, rng):
    a, w = _attention_case(rng, mode, masked)
    nq, D = a["xyz_q"].shape[1], w[2].shape[0]
    G = rng.randn(a["xyz_q"].shape[0], nq, D).astype(np.float32)
    ref = _jax_grads(a, w, G)
    got, mask = _port_grads(a, w, G)
    _assert_grads_close(got, ref)  # within rtol 1e-3 / atol 1e-4; gamma_b1 absolutely
    assert mask is None or mask.grad is None  # the mask only shapes the selection


@pytest.mark.parametrize("mode", ["pos_only", "table", "proj", "global"])
def test_attention_gradcheck(mode):
    """float64 finite differences through the port's autograd function.
    Points on a jittered grid 1 apart: the selection cannot move under the
    1e-6 steps."""
    rng = np.random.RandomState(5)
    a, w = _attention_case(rng, mode, mode == "table", B=1, M=12, D=4, k=3, F=3, nq=5)
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
    kv = (grid[rng.permutation(27)[:12]] + 0.1 * rng.rand(12, 3))[None]
    a["kv_xyz"] = kv
    a["xyz_q"] = kv if mode in ("pos_only", "table") else (
        kv[:, :5] if mode == "proj" else 3.0 * rng.rand(1, 5, 3))
    leaf = lambda x: torch.tensor(np.asarray(x, np.float64), requires_grad=True)
    names = [n for n in FEATURES if a.get(n) is not None]
    inputs = [leaf(a[n]) for n in names] + [leaf(x) for x in w]
    mask = None if a.get("kv_mask") is None else torch.tensor(a["kv_mask"])

    def f(*args):
        feats = dict(zip(names, args[:len(names)]))
        extra = {n: feats[n] for n in ("k_glob", "v_glob", "kv_feats", "wk", "wv") if n in feats}
        return port_attention.fused_vector_attention(
            feats["xyz_q"], feats["kv_xyz"], feats.get("q_feats"), feats.get("K_a"),
            feats.get("V_a"), *args[len(names):], k=a["k"], kv_mask=mask, **extra)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6, rtol=1e-5)


def _bn_case(rng, masked):
    x = rng.randn(2, 9, 5).astype(np.float32) * 2.0 + 0.5
    mask = (rng.rand(2, 9) > 0.4).astype(np.float32) if masked else None
    scale = (1.0 + 0.1 * rng.randn(5)).astype(np.float32)
    bias = (0.1 * rng.randn(5)).astype(np.float32)
    mean = (0.1 * rng.randn(5)).astype(np.float32)
    var = (1.0 + rng.rand(5)).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    bn = BatchNorm(5, device="cpu")
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    return x, mask, variables, bn


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_mode_matches_jax(masked, rng):
    x, mask, variables, bn = _bn_case(rng, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    ref, mutated = JaxBatchNorm().apply(variables, jnp.asarray(x), True, jmask,
                                        mutable=["batch_stats"])
    got = bn.train()(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6, atol=1e-7)
    # the running variance takes the Bessel-corrected variance over the valid rows
    flat = x.reshape(-1, 5)
    rows = flat if mask is None else flat[mask.reshape(-1) > 0]
    want = 0.9 * variables["batch_stats"]["bn"]["var"] + 0.1 * rows.var(axis=0, ddof=1)
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1e-5)


def test_batchnorm_eval_mode_is_unchanged(rng):
    x, mask, variables, bn = _bn_case(rng, True)
    ref = JaxBatchNorm().apply(variables, jnp.asarray(x), False, jnp.asarray(mask))
    before = (bn.running_mean.clone(), bn.running_var.clone())
    got = bn.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])
