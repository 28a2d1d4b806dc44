"""The captured service (``graphs=True``, on the CPU its static-buffer
contract) == ``nsdp_tpu``'s ``DeformationService`` on the same weights,
within ``tests/test_torch_serving.py``'s tolerance."""

import numpy as np
import pytest

from nsdp_tpu.serving import DeformationService as JaxService
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.utils.convert import from_jax_variables
from tests.test_fast_predict import CFG
from tests.test_torch_serving import TOL, _request


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
