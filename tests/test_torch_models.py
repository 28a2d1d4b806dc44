"""nsdp_tpu_torch encoder/decoder == nsdp_tpu flax modules (eval) on the CPU,
and the weight carry-over between the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.models.decoders import CrossTransformerDecoder as JaxDecoder
from nsdp_tpu.models.encoders import PointTransformerEncoder as JaxEncoder
from nsdp_tpu.utils.torch_convert import translate_state_dict
from nsdp_tpu_torch.models import build_model
from nsdp_tpu_torch.models.decoders import CrossTransformerDecoder
from nsdp_tpu_torch.models.encoders import PointTransformerEncoder
from nsdp_tpu_torch.utils.convert import from_jax_variables
from tests.test_fast_predict import CFG

ENC_KW = dict(
    npoints_per_layer=[48, 16, 8], nneighbor=6, nneighbor_reduced=4,
    nfinal_transformers=2, d_transformer=16, d_reduced=12,
)
DEC_KW = dict(dim_inp=16, dim=12, nneigh=5, hidden_dim=8, n_blocks=3, out_dim=3)


def randomize(variables, rng):
    """Numpy copy of flax variables with every weight and BatchNorm
    statistic drawn at random (a fresh init has unit BN statistics and
    zero-initialised layers, which would hide layout mistakes).  Variances
    stay >= 1 so activations keep unit scale through the residual stack."""

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1] == "var":
            return (1.0 + rng.rand(*leaf.shape)).astype(np.float32)
        if path[-1] in ("mean", "bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if path[-1] == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (rng.randn(*leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)

    out = {}
    for col in ("params", "batch_stats"):
        flat = flatten_dict(jax.tree_util.tree_map(np.asarray, dict(variables.get(col, {}))))
        tree = {}
        for path, leaf in flat.items():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = draw(path, leaf)
        out[col] = tree
    return out


def load_port(module, variables):
    module.load_state_dict(
        from_jax_variables(variables["params"], variables["batch_stats"]), strict=True
    )
    return module.eval()


@pytest.mark.parametrize("full_sa", [True, False])
@pytest.mark.parametrize("has_features", [False, True])
def test_encoder_matches_jax(has_features, full_sa, rng):
    kw = dict(ENC_KW, full_SA=full_sa, has_features=has_features, inp_feat_dim=4)
    B, N = 2, 48
    xyz = rng.randn(B, N, 7 if has_features else 3).astype(np.float32)
    jenc = JaxEncoder(**kw)
    variables = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(xyz)), rng)
    ref = jenc.apply(variables, jnp.asarray(xyz), train=False)
    port = load_port(PointTransformerEncoder(**kw), variables)
    got = port(torch.from_numpy(xyz))
    for key in ("z", "anchors", "anchor_feats"):
        np.testing.assert_allclose(
            got[key].detach().numpy(), np.asarray(ref[key]),
            rtol=1e-4, atol=1e-5, err_msg=key,
        )


def test_decoder_matches_jax(rng):
    B, Q, A = 2, 70, 24
    enc = {
        "z": rng.randn(B, 16).astype(np.float32),
        "anchors": rng.randn(B, A, 3).astype(np.float32),
        "anchor_feats": rng.randn(B, A, 16).astype(np.float32),
    }
    xyz_q = rng.randn(B, Q, 3).astype(np.float32)
    jdec = JaxDecoder(**DEC_KW)
    jenc = {key: jnp.asarray(v) for key, v in enc.items()}
    variables = randomize(jdec.init(jax.random.PRNGKey(1), jnp.asarray(xyz_q), jenc), rng)
    ref = jdec.apply(variables, jnp.asarray(xyz_q), jenc)
    port = load_port(CrossTransformerDecoder(**DEC_KW), variables)
    got = port(torch.from_numpy(xyz_q), {key: torch.from_numpy(v) for key, v in enc.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_weight_round_trip(rng):
    """from_jax_variables loads strictly, and the JAX package's own torch ->
    flax converter maps the port's state_dict back onto the same tree."""
    jmodel = jax_build_model(CFG)
    pts = jnp.asarray(rng.randn(1, 20, 3).astype(np.float32))
    surf = jnp.asarray(rng.randn(1, 32, 3).astype(np.float32))
    mask = jnp.ones((1, 32, 1), jnp.float32)
    variables = randomize(jmodel.init(jax.random.PRNGKey(0), pts, surf, surf, mask), rng)
    port = load_port(build_model(CFG, device="cpu"), variables)
    sd = {key: v.numpy() for key, v in port.state_dict().items()}
    params, batch_stats = translate_state_dict(sd)
    for col, flat in (("params", params), ("batch_stats", batch_stats)):
        want = flatten_dict(variables[col])
        assert sorted(flat) == sorted(want), col
        for key, v in want.items():
            np.testing.assert_array_equal(flat[key], v, err_msg="/".join(key))


@pytest.mark.parametrize("key,value,builds", [
    ("compute_dtype", "float32", True), ("remat", False, True),
    ("compute_dtype", "not_a_dtype", TypeError), ("compute_dtype", "int32", ValueError),
])
def test_build_model_refuses_keys_it_cannot_honour(key, value, builds):
    """A ``compute_dtype`` name that is no dtype raises ``TypeError``, as
    ``jnp.dtype`` does in the JAX package's ``build_model``, and one that is
    no floating type ``ValueError``; float32 and ``remat: false`` build as
    without the keys.  (bfloat16, float16 and ``remat: true`` build and are
    held against the JAX package in ``tests/test_torch_dtype.py``.)"""
    cfg = {"model": dict(CFG["model"], **{key: value})}
    if builds is True:
        assert isinstance(build_model(cfg, device="cpu"), torch.nn.Module)
    else:
        with pytest.raises(builds):
            build_model(cfg, device="cpu")
        if builds is TypeError:
            with pytest.raises(TypeError):
                jnp.dtype(value)
