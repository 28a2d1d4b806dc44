"""The port's stage-2 ('arbitrary') training step == the JAX package's, on
the CPU: the loss, parameter and running-statistics trajectories, with and
without a ``surface_valid_mask``.

Stage 2 is where the coordinate gradients matter: the canonicalised points
are the forward net's inputs, so the loss reaches ``model_canonicalize``
through the attention's coordinate gradients and the detached set-abstraction
centres; its encoder's running statistics take the compound EMA.  Helpers
and the JAX side's setting are in ``tests/test_torch_training.py``.
"""

import numpy as np
import pytest

from tests.test_torch_training import (
    assert_first_moments_close,
    assert_trees_close,
    batches,
    jax_variables,
    train_both,
)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_stage2_steps_match_jax(masked):
    """3 steps at the reference's stage-2 rate (5e-5, no weight decay)."""
    n, lr = 3, 5e-5
    cfg = {"optimizer": "Adam", "lr": lr, "lr_step": 2, "lr_decay": 0.5}
    losses, jlosses, model, opt, state = train_both("arbitrary", batches(2, n, masked=masked), cfg)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=2e-6)
    assert_first_moments_close(model, opt, state)
    params, stats = jax_variables(model)
    assert_trees_close(state.params, params, 2.5 * lr * n, 2.5 * lr * n, "params")
    assert_trees_close(state.batch_stats, stats, 5e-4, 5e-4, "batch_stats")
