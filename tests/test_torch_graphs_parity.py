"""The captured programs on the CPU's static-buffer contract
(``graphs=True``) == ``nsdp_tpu``'s jitted functions on the same weights:
the service against ``DeformationService`` within
``tests/test_torch_serving.py``'s tolerance, and ``make_steps``'
evaluation steps against the JAX steps within the tolerances of the eager
parity tests (``tests/test_torch_training.py``,
``tests/test_torch_train_parts.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.serving import DeformationService as JaxService
from nsdp_tpu.training import make_steps as jax_make_steps
from nsdp_tpu.training import optimizer_factory as jax_optimizer_factory
from nsdp_tpu.training import create_train_state
from nsdp_tpu_torch.models import build_model
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.training import make_steps, optimizer_factory
from nsdp_tpu_torch.utils.convert import from_jax_variables
from tests.test_fast_predict import CFG
from tests.test_torch_serving import TOL, _request
from tests.test_torch_training import batches, config

# the stage-1 losses' tolerance of tests/test_torch_training.py
LOSS_TOL = dict(rtol=5e-4, atol=1e-5)


@pytest.fixture(scope="module")
def services():
    cfg = {"model": dict(CFG["model"]), "training": {"optimizer": "Adam", "lr": 1e-3}}
    jax_svc = JaxService(cfg, buckets=(64,), use_fused=False)
    state = from_jax_variables(jax_svc.state.params, jax_svc.state.batch_stats)
    return jax_svc, DeformationService(cfg, state_dict=state, buckets=(64,), device="cpu",
                                       graphs=True)


def test_captured_service_matches_jax(services, rng):
    jax_svc, svc = services
    pts, surf, tgt, handle = _request(rng)
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    for args in ((pts, inputs, None), (pts, inputs * pm[:, None], pm)):
        np.testing.assert_allclose(svc.deform(*args), jax_svc.deform(*args), **TOL)
    session, jax_session = svc.edit_session(pts, surf), jax_svc.edit_session(pts, surf)
    other = svc.edit_session(pts[::-1].copy(), surf[::-1].copy())  # the same bucket
    for scale in (1.0, 0.5):
        np.testing.assert_allclose(session.drag(tgt * scale, handle),
                                   jax_session.drag(tgt * scale, handle), **TOL)
        other.drag(tgt * scale, handle)
    assert len(svc.graphs[0].programs) == 4  # deform plain and masked, canonicalize, drag


@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_captured_evaluation_steps_match_jax(model_type):
    """``validate_step`` and ``validate_step_masked`` (``LOSS_TOL``),
    ``predict`` (``TOL``) and ``watch_stats`` (the parameter norms within
    rtol 1e-5, the gradient norms within rtol 1e-3 and 1e-6 of the largest,
    as ``tests/test_torch_train_parts.py`` holds them) on the captured
    contract against the JAX package's jitted steps, four calls of one
    signature on padded partial shapes.  The weights are the JAX model's
    own initialisation, as the service's parity tests take them."""
    cfg = dict(config(model_type), training={"optimizer": "Adam", "lr": 1e-3})
    _, tx = jax_optimizer_factory(cfg["training"])
    jax_model = jax_build_model(cfg)
    rng = np.random.RandomState(0)
    surf = jnp.asarray(rng.randn(1, 24, 3), jnp.float32)
    mask = jnp.ones((1, 24, 1), jnp.float32)
    pts = jnp.asarray(rng.randn(1, 10, 3), jnp.float32)
    example = ((pts, surf, surf, mask) if model_type == "arbitrary"
               else (pts, jnp.concatenate([surf, surf, mask], -1)))
    state = create_train_state(jax_model, jax.random.PRNGKey(0), example, tx)
    jsteps = jax_make_steps(jax_model, model_type, tx)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(state.params, state.batch_stats))
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    steps = make_steps(model, model_type, opt, device="cpu", graphs=True)
    sample_mask = np.array([1.0, 0.0], np.float32)
    for batch in batches(31, 2, masked=True) * 2:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        np.testing.assert_allclose(steps["validate_step"](batch),
                                   float(jsteps["validate_step"](state, jbatch)), **LOSS_TOL)
        np.testing.assert_allclose(
            steps["validate_step_masked"](batch, sample_mask),
            float(jsteps["validate_step_masked"](state, jbatch, jnp.asarray(sample_mask))),
            **LOSS_TOL)
        args = (batch["space_samples_src"], batch["surface_samples_inputs"],
                batch["surface_valid_mask"])
        np.testing.assert_allclose(steps["predict"](*args).numpy(),
                                   np.asarray(jsteps["predict"](state, *map(jnp.asarray, args))),
                                   **TOL)
        (p_top, p_leaves), (g_top, g_leaves) = steps["watch_stats"](batch)
        (jp_top, jp_leaves), (jg_top, jg_leaves) = jsteps["watch_stats"](state, jbatch)
        for name in p_top:
            np.testing.assert_allclose(p_top[name], float(jp_top[name]), rtol=1e-5)
            np.testing.assert_allclose(g_top[name], float(jg_top[name]), rtol=1e-3)
        np.testing.assert_allclose(np.sort(p_leaves), np.sort(np.asarray(jp_leaves)), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(np.sort(g_leaves), np.sort(np.asarray(jg_leaves)), rtol=1e-3,
                                   atol=1e-6 * float(np.max(g_leaves)))
    programs = steps["predict"].graphs.programs
    assert sorted(name for name, _ in programs) == [
        "predict", "validate_step", "validate_step_masked", "watch_stats"]
    assert all(p.calls == 4 for p in programs.values())
