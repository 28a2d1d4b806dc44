"""The port's whole 'arbitrary' predict == nsdp_tpu's fused predict on the CPU.

The JAX side is ``make_fast_predict(..., interpret=True)`` -- the fused
serving path with the Pallas kernels in interpret mode; the port runs its
plain PyTorch versions.  Tolerances as ``tests/test_fast_predict.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.models.fast_predict import make_fast_predict
from nsdp_tpu_torch.models import build_model
from tests.test_fast_predict import CFG
from tests.test_torch_models import load_port, randomize


def _inputs(rng, masked, B=2, N=32, Q=20):
    surf_src = rng.randn(B, N, 3).astype(np.float32)
    surf_tgt = rng.randn(B, N, 3).astype(np.float32)
    handle = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    pts = rng.randn(B, Q, 3).astype(np.float32)
    pm = None
    if masked:  # padded-partial conditioning: padded rows zero
        pm = np.ones((B, N), np.float32)
        pm[:, -6:] = 0.0
        surf_src, surf_tgt, handle = (a * pm[..., None] for a in (surf_src, surf_tgt, handle))
    inputs = np.concatenate([surf_src, surf_tgt * handle, handle], -1)
    return pts, inputs, pm


@pytest.mark.parametrize("masked", [False, True])
def test_arbitrary_predict_matches_jax(masked, rng):
    pts, inputs, pm = _inputs(rng, masked)
    jmodel = jax_build_model(CFG)
    j = jnp.asarray
    variables = randomize(
        jmodel.init(jax.random.PRNGKey(0), j(pts), j(inputs[..., 0:3]),
                    j(inputs[..., 3:6]), j(inputs[..., 6:7])),
        rng,
    )
    predict = make_fast_predict(jmodel, variables, "arbitrary", nneigh=5, interpret=True)
    margs = () if pm is None else (j(pm),)
    ref = np.asarray(predict(j(pts), j(inputs), *margs))

    port = load_port(build_model(CFG, device="cpu"), variables)
    t = torch.from_numpy
    tpm = None if pm is None else t(pm)
    with torch.inference_mode():
        got = port.predict(t(pts), t(inputs), tpm)
        space_cano, surf_cano = port.canonicalize(t(pts), t(inputs[..., 0:3]), tpm)
        split = port.deform(space_cano, surf_cano, t(inputs[..., 3:6]),
                            t(inputs[..., 6:7]), tpm)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=2e-4)
    # the split at the canonical pose is the same computation
    np.testing.assert_array_equal(split.numpy(), got.numpy())
    if pm is not None:
        assert not surf_cano.numpy()[pm == 0].any()
