"""The port's PointNet++ model family == the JAX package's, on the CPU, in eval
mode: the ``pointnet++`` encoder, the ``interp`` decoder, the pointnet2 API
layer, and the weight carry-over of the two ablation configurations.

The configurations are built as ``tests/test_torch_graphs.py``'s
``shipped_config`` builds them at the published widths, from a shipped
config with only the module swapped (``ablation``); here at small widths.  A (encoder ablation): ``pointnet++`` + ``crossatten``, type
``arbitrary``; B (decoder ablation): ``pointnet++`` + ``interp``, type
``forward``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.models.decoders import PointInterpDecoder as JaxInterpDecoder
from nsdp_tpu.models.encoders import PointNetPlusPlusEncoder as JaxPointNetEncoder
from nsdp_tpu.ops import pointnet2_compat as jax_pn2
from nsdp_tpu.utils.torch_convert import translate_state_dict
from nsdp_tpu_torch.models import build_model
from nsdp_tpu_torch.models.decoders import PointInterpDecoder
from nsdp_tpu_torch.models.encoders import PointNetPlusPlusEncoder
from nsdp_tpu_torch.ops import pointnet2_compat as port_pn2
from nsdp_tpu_torch.utils.convert import from_jax_variables
from tests.test_torch_models import load_port, randomize

ENC_KW = dict(npoints_per_layer=[48, 16, 8], nneighbor=6, d_transformer=16,
              nfinal_transformers=2)
TOL = dict(rtol=1e-4, atol=1e-5)

SHIPPED_SMALL = {"model": {
    "use_normals": False, "fused_attention": True, "encoder": "pointransformer",
    "encoder_kwargs": dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nneighbor_reduced=4,
                           nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True),
    "decoder": "crossatten",
    "decoder_kwargs": dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3),
    "type": "arbitrary",
}}


def ablation(cfg, name):
    """Configuration A or B from a shipped config: swap the module, keep
    the widths (``tests/test_partial_padded.py:193-204``)."""
    cfg = copy.deepcopy(cfg)
    model = cfg["model"]
    model["encoder"] = "pointnet++"
    for key in ("nneighbor_reduced", "d_reduced", "full_SA"):
        model["encoder_kwargs"].pop(key, None)
    if name == "A":
        model["type"] = "arbitrary"
    else:
        model["type"] = "forward"
        model["decoder"] = "interp"
        model["decoder_kwargs"].pop("nneigh", None)
    return cfg


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "point_mask"])
@pytest.mark.parametrize("has_features", [False, True], ids=["xyz", "features"])
def test_pointnet_encoder_matches_jax(has_features, masked, rng):
    kw = dict(ENC_KW, has_features=has_features, inp_feat_dim=4)
    B, N = 2, 48
    xyz = rng.randn(B, N, 7 if has_features else 3).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, N), np.float32)
        mask[0, -9:] = 0.0
        mask[1, -4:] = 0.0
        xyz = xyz * mask[..., None]
    jenc = JaxPointNetEncoder(**kw)
    variables = randomize(jenc.init(jax.random.PRNGKey(0), _j(xyz)), rng)
    ref = jenc.apply(variables, _j(xyz), False, None if mask is None else _j(mask))
    port = load_port(PointNetPlusPlusEncoder(**kw), variables)
    got = port(_t(xyz), None if mask is None else _t(mask))
    for key in ("z", "anchors", "anchor_feats"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)


def test_interp_decoder_matches_jax(rng):
    """Queries within the anchors' extent: farther than ~2.03 from every
    anchor, the unshifted Gaussian weights underflow (NaN on both sides)."""
    kw = dict(dim_inp=16, dim=12, hidden_dim=8, n_blocks=3, out_dim=3)
    B, Q, A = 2, 70, 24
    enc = {"z": rng.randn(B, 16).astype(np.float32),
           "anchors": rng.uniform(-1, 1, (B, A, 3)).astype(np.float32),
           "anchor_feats": rng.randn(B, A, 16).astype(np.float32)}
    xyz_q = rng.uniform(-1, 1, (B, Q, 3)).astype(np.float32)
    jdec = JaxInterpDecoder(**kw)
    jenc = {key: _j(v) for key, v in enc.items()}
    variables = randomize(jdec.init(jax.random.PRNGKey(1), _j(xyz_q), jenc), rng)
    ref = jdec.apply(variables, _j(xyz_q), jenc)
    port = load_port(PointInterpDecoder(**kw), variables)
    got = port(_t(xyz_q), {key: _t(v) for key, v in enc.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_interp_decoder_underflows_as_the_reference_does():
    """Far from every anchor the weights are all 0 and the output NaN, in
    both packages: the port keeps the reference's arithmetic (no max
    shift)."""
    enc = {"z": np.zeros((1, 4), np.float32), "anchors": np.zeros((1, 3, 3), np.float32),
           "anchor_feats": np.ones((1, 3, 4), np.float32)}
    q = np.full((1, 2, 3), 3.0, np.float32)
    port = PointInterpDecoder(4, 4, hidden_dim=4, n_blocks=1)
    jdec = JaxInterpDecoder(4, 4, hidden_dim=4, n_blocks=1)
    jenc = {key: _j(v) for key, v in enc.items()}
    ref = jdec.apply(jdec.init(jax.random.PRNGKey(0), _j(q), jenc), _j(q), jenc)
    assert np.isnan(np.asarray(ref)).all()
    assert torch.isnan(port(_t(q), {key: _t(v) for key, v in enc.items()})).all()


@pytest.mark.parametrize("name", ["A", "B"])
def test_weight_round_trip_ablations(name, rng):
    """As ``tests/test_torch_models.py::test_weight_round_trip``, for the two
    ablation configurations: from_jax_variables loads strictly, and the JAX
    package's translate_state_dict maps the port's state_dict back."""
    cfg = ablation(SHIPPED_SMALL, name)
    jmodel = jax_build_model(cfg)
    pts = _j(rng.randn(1, 20, 3).astype(np.float32))
    surf = _j(rng.randn(1, 32, 3).astype(np.float32))
    mask = jnp.ones((1, 32, 1), jnp.float32)
    if name == "A":
        init = jmodel.init(jax.random.PRNGKey(0), pts, surf, surf, mask)
    else:
        init = jmodel.init(jax.random.PRNGKey(0), pts, jnp.concatenate([surf, surf, mask], -1))
    variables = randomize(init, rng)
    port = load_port(build_model(cfg, device="cpu"), variables)
    sd = {key: v.numpy() for key, v in port.state_dict().items()}
    params, batch_stats = translate_state_dict(sd)
    for col, flat in (("params", params), ("batch_stats", batch_stats)):
        want = flatten_dict(variables[col])
        assert sorted(flat) == sorted(want), col
        for key, v in want.items():
            np.testing.assert_array_equal(flat[key], v, err_msg="/".join(key))


def test_ablation_predict_matches_jax(rng):
    """Configuration A's whole predict (``FlowArbitrary``: both pointnet++
    encoders, three crossatten decodes) against the JAX package's flax eval
    path with the fused attention, as the shipped config sets it."""
    cfg = ablation(SHIPPED_SMALL, "A")
    jmodel = jax_build_model(cfg)
    src = rng.randn(2, 32, 3).astype(np.float32)
    tgt = rng.randn(2, 32, 3).astype(np.float32)
    handle = (rng.rand(2, 32, 1) > 0.5).astype(np.float32)
    pts = rng.randn(2, 20, 3).astype(np.float32)
    args = [_j(pts), _j(src), _j(tgt * handle), _j(handle)]
    variables = randomize(jmodel.init(jax.random.PRNGKey(0), *args), rng)
    ref = jmodel.apply(variables, *args)
    port = load_port(build_model(cfg, device="cpu"), variables)
    got = port(_t(pts), _t(src), _t(tgt * handle), _t(handle))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- pointnet2 API


def _compat_inputs(rng):
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    return xyz, rng.randn(2, 6, 64).astype(np.float32)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_query_and_group_matches_jax(use_xyz, rng):
    xyz, feats = _compat_inputs(rng)
    got = port_pn2.query_and_group(0.5, 9, _t(xyz), _t(xyz[:, :16]), _t(feats), use_xyz)
    ref = jax_pn2.query_and_group(0.5, 9, _j(xyz), _j(xyz[:, :16]), _j(feats), use_xyz)
    assert got.shape == ((2, 9, 16, 9) if use_xyz else (2, 6, 16, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    rel = port_pn2.query_and_group(10.0, 5, _t(xyz[:1, :32]), _t(xyz[:1, :4]))
    np.testing.assert_allclose(rel[0, :, :, 0].T.numpy(), xyz[0, 0][None] - xyz[0, :4], atol=1e-6)


def test_group_all_matches_jax(rng):
    xyz, feats = _compat_inputs(rng)
    for f, use_xyz in ((feats, True), (feats, False), (None, True)):
        got = port_pn2.group_all(_t(xyz), None if f is None else _t(f), use_xyz)
        ref = jax_pn2.group_all(_j(xyz), None if f is None else _j(f), use_xyz)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _pn2_both(jmod, port, args, rng, train):
    """Apply a flax pointnet2 module and its port from the same random
    variables, in eval or train mode -> (flax out, port out, flax new
    batch_stats, port)."""
    jargs = [None if a is None else _j(a) for a in args]
    variables = randomize(jmod.init(jax.random.PRNGKey(0), *jargs, train=False), rng)
    load_port(port, variables)
    if train:
        ref, state = jmod.apply(variables, *jargs, train=True, mutable=["batch_stats"])
        port.train()
    else:
        ref, state = jmod.apply(variables, *jargs, train=False), None
    got = port(*[None if a is None else _t(a) for a in args])
    return ref, got, state, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["single", "msg", "group_all"])
def test_sa_module_matches_jax(kind, train, rng):
    """Train mode: flax's own BatchNorm (biased running variance, momentum
    0.9) -- outputs and the running statistics after the step."""
    xyz, feats = _compat_inputs(rng)
    if kind == "single":
        jmod = jax_pn2.PointnetSAModule.create(mlp=[6 + 3, 16, 32], npoint=16, radius=0.8, nsample=8)
        port = port_pn2.PointnetSAModule.create(mlp=[6 + 3, 16, 32], npoint=16, radius=0.8,
                                                nsample=8, in_channels=6)
    elif kind == "msg":
        kw = dict(npoint=16, radii=[0.4, 0.8], nsamples=[4, 8], mlps=[[9, 16], [9, 24]])
        jmod, port = jax_pn2.PointnetSAModuleMSG(**kw), port_pn2.PointnetSAModuleMSG(**kw, in_channels=6)
    else:
        jmod = jax_pn2.PointnetSAModule.create(mlp=[12, 20])
        port = port_pn2.PointnetSAModule.create(mlp=[12, 20], in_channels=6)
    ref, got, state, port = _pn2_both(jmod, port, (xyz, feats), rng, train)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(ref[1]), **TOL)
    if train:
        stats = from_jax_variables({}, state["batch_stats"])
        for key, v in port.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), stats[key].numpy(), **TOL, err_msg=key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fp_module_matches_jax(train, rng):
    unknown = rng.randn(2, 64, 3).astype(np.float32)
    known = rng.randn(2, 16, 3).astype(np.float32)
    known_feats = rng.randn(2, 32, 16).astype(np.float32)
    skip_feats = rng.randn(2, 8, 64).astype(np.float32)
    jmod = jax_pn2.PointnetFPModule(mlp=[40, 24])
    port = port_pn2.PointnetFPModule(mlp=[40, 24], in_channels=32 + 8)
    ref, got, _, _ = _pn2_both(jmod, port, (unknown, known, skip_feats, known_feats), rng, train)
    assert got.shape == (2, 24, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------- serving A


def test_service_serves_configuration_a_as_jax_does(rng):
    """Configuration A through both ``DeformationService``s (the JAX one on
    its flax path) from the same weights: a request, a masked request, and
    an edit session with two drags."""
    from nsdp_tpu.serving import DeformationService as JaxService
    from nsdp_tpu_torch.serving import DeformationService

    cfg = dict(ablation(SHIPPED_SMALL, "A"), training={"optimizer": "Adam", "lr": 1e-3})
    jax_svc = JaxService(cfg, buckets=(64,), use_fused=False)
    state = from_jax_variables(jax_svc.state.params, jax_svc.state.batch_stats)
    svc = DeformationService(cfg, state_dict=state, buckets=(64,), device="cpu")
    tol = dict(rtol=1e-3, atol=2e-4)
    surf = rng.randn(32, 3).astype(np.float32)
    handle = (rng.rand(32, 1) > 0.5).astype(np.float32)
    tgt = rng.randn(32, 3).astype(np.float32) * handle
    pts = rng.randn(50, 3).astype(np.float32)
    inputs = np.concatenate([surf, tgt, handle], -1)
    np.testing.assert_allclose(svc.deform(pts, inputs), jax_svc.deform(pts, inputs), **tol)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    np.testing.assert_allclose(svc.deform(pts, inputs * pm[:, None], point_mask=pm),
                               jax_svc.deform(pts, inputs * pm[:, None], point_mask=pm), **tol)
    session, jax_session = svc.edit_session(pts, surf), jax_svc.edit_session(pts, surf)
    for scale in (1.0, 0.5):
        dragged = session.drag(tgt * scale, handle)
        np.testing.assert_allclose(dragged, jax_session.drag(tgt * scale, handle), **tol)
        full = svc.deform(pts, np.concatenate([surf, tgt * scale, handle], -1))
        np.testing.assert_allclose(dragged, full, rtol=1e-5, atol=1e-6)
