"""The port reads the JAX package's model files, and ``DeformationService``
warms at construction, on the CPU.

``nsdp_tpu.training.checkpoints.save_checkpoints`` writes ``model_*`` as
flax msgpack of ``{"params", "batch_stats"}``; the port's
``read_state_dict`` decodes it with its own reader
(``nsdp_tpu_torch/utils/msgpack_reader.py``, no ``msgpack`` or ``flax``) and
maps it through ``from_jax_variables``.  Every weight path goes through it:
the service, ``test``/``run``'s ``test.weight_file`` and ``train``'s three
weight flags, each held bit for bit against the same variables.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import nsdp_tpu_torch.run as port_run
import nsdp_tpu_torch.test as port_test
from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.training import optimizer_factory as jax_optimizer_factory
from nsdp_tpu.training.checkpoints import save_checkpoints as jax_save_checkpoints
from nsdp_tpu.training.state import TrainState
from nsdp_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    generate_userhandle_dataset,
    synthetic_config,
)
from nsdp_tpu_torch.models import build_model
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.train import load_weights
from nsdp_tpu_torch.training import (
    load_subnetwork,
    optimizer_factory,
    read_state_dict,
    save_checkpoints,
)
from nsdp_tpu_torch.utils.convert import from_jax_variables
from nsdp_tpu_torch.utils.msgpack_reader import unpackb
from tests.test_torch_entry_points import HEAD_HANDLE
from tests.test_torch_models import randomize
from tests.test_torch_training import config


def jax_model_file(directory, cfg, rng, seed=0):
    """A ``model_00000`` written by the JAX package's checkpointing from
    randomised variables of ``cfg``'s model -> (path, variables)."""
    jmodel = jax_build_model(cfg)
    pts = jnp.asarray(rng.randn(1, 10, 3).astype(np.float32))
    surf = jnp.asarray(rng.randn(1, 24, 3).astype(np.float32))
    mask = jnp.ones((1, 24, 1), jnp.float32)
    args = ((pts, surf, surf, mask) if cfg["model"]["type"] == "arbitrary"
            else (pts, jnp.concatenate([surf, surf * mask, mask], -1)))
    variables = randomize(jmodel.init(jax.random.PRNGKey(seed), *args, train=False), rng)
    _, tx = jax_optimizer_factory({"optimizer": "Adam", "lr": 1e-3})
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    os.makedirs(directory, exist_ok=True)
    jax_save_checkpoints(0, state, str(directory))
    return os.path.join(str(directory), "model_00000"), variables


def assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


def expected(variables):
    return from_jax_variables(variables["params"], variables["batch_stats"])


@pytest.mark.parametrize("model_type", ["forward", "backward", "arbitrary"])
def test_jax_model_files_read_bit_for_bit(model_type, tmp_path, rng):
    path, variables = jax_model_file(tmp_path, config(model_type), rng)
    with open(path, "rb") as f:
        assert f.read(1)[0] in range(0x81, 0x90)  # a msgpack map
    state = read_state_dict(path)
    assert_state_equal(state, expected(variables))
    model = build_model(config(model_type), device="cpu")
    model.load_state_dict(state, strict=True)


def test_stage1_files_graft_into_the_branches_and_train_reads_every_flag(tmp_path, rng):
    """``load_subnetwork`` puts a JAX stage-1 file into one branch of
    'arbitrary', and ``train``'s ``weight_forward_file`` /
    ``weight_backward_file`` / ``weight_file`` read JAX files."""
    fwd, fvars = jax_model_file(tmp_path / "fwd", config("forward"), rng, seed=1)
    bwd, bvars = jax_model_file(tmp_path / "bwd", config("backward"), rng, seed=2)
    arb, avars = jax_model_file(tmp_path / "arb", config("arbitrary"), rng, seed=3)

    model = build_model(config("arbitrary"), device="cpu")
    load_subnetwork(model, fwd, "model_deform")
    assert_state_equal(model.model_deform.state_dict(), expected(fvars))

    model = build_model(config("arbitrary"), device="cpu")
    cfg = dict(config("arbitrary"), training={"weight_forward_file": fwd,
                                              "weight_backward_file": bwd})
    load_weights(model, cfg)
    assert_state_equal(model.model_deform.state_dict(), expected(fvars))
    assert_state_equal(model.model_canonicalize.state_dict(), expected(bvars))
    load_weights(model, dict(config("arbitrary"), training={"weight_file": arb}))
    assert_state_equal(model.state_dict(), expected(avars))


def test_service_serves_a_jax_model_file(tmp_path, rng):
    """``DeformationService(weight_file=<JAX file>)`` and ``from_config``
    with it as ``test.weight_file`` serve the bits of ``state_dict=``."""
    cfg = config("arbitrary")
    path, variables = jax_model_file(tmp_path, cfg, rng)
    pts = rng.randn(40, 3).astype(np.float32)
    inputs = np.concatenate([rng.randn(24, 6), np.ones((24, 1))], -1).astype(np.float32)
    want = DeformationService(cfg, state_dict=expected(variables), device="cpu",
                              buckets=(64,)).deform(pts, inputs)
    got = DeformationService(cfg, weight_file=path, device="cpu", buckets=(64,))
    np.testing.assert_array_equal(got.deform(pts, inputs), want)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(cfg, test={"weight_file": path}, data={},
                                            experiment={"name": "x", "out_dir": "out"})))
    svc = DeformationService.from_config(str(cfg_path), device="cpu", buckets=(64,))
    np.testing.assert_array_equal(svc.deform(pts, inputs), want)


def test_bfloat16_leaves_decode_as_bfloat16(tmp_path, rng):
    """A bfloat16 leaf decodes as ``torch.bfloat16``, value for value; a
    model file of bfloat16 leaves loads as their float32 values."""
    x = rng.randn(3, 5).astype(np.float32)
    tree = {"a": {"b": jnp.asarray(x).astype(jnp.bfloat16)}, "s": np.float32(2.5)}
    out = unpackb(serialization.msgpack_serialize(tree))
    assert out["a"]["b"].dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(out["a"]["b"].float().numpy(), want)
    assert out["s"].dtype == torch.float32 and float(out["s"]) == 2.5

    path, variables = jax_model_file(tmp_path, config("forward"), rng)
    narrow = jax.tree_util.tree_map(lambda v: jnp.asarray(v).astype(jnp.bfloat16),
                                    {"params": variables["params"],
                                     "batch_stats": variables["batch_stats"]})
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(narrow))
    widened = jax.tree_util.tree_map(lambda v: np.asarray(v.astype(jnp.float32)), narrow)
    assert_state_equal(read_state_dict(path), expected(widened))


@pytest.mark.parametrize("payload,match", [
    ({"params": msgpack.ExtType(5, b"\x00")}, "extension type 5"),
    ({"params": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))}, "native_complex"),
    ({"params": {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 3}}}}, "chunked"),
])
def test_what_the_reader_does_not_read_raises(payload, match, tmp_path):
    path = tmp_path / "model_00000"
    path.write_bytes(msgpack.packb(payload))
    with pytest.raises(ValueError, match=match):
        read_state_dict(str(path))


@pytest.mark.parametrize("warm", [False, True])
def test_service_warms_at_construction(warm, monkeypatch):
    """``warm=True`` runs ``warmup`` once, at the JAX service's 256 surface
    points (``nsdp_tpu/serving.py:55,108-109``); ``from_config`` passes it."""
    calls = []
    monkeypatch.setattr(DeformationService, "warmup", lambda self, n: calls.append(n))
    DeformationService(config("forward"), device="cpu", warm=warm)
    assert calls == ([256] if warm else [])


def _run_cli(cli, cfg, weight_file, tmp_path, name):
    cfg = dict(cfg, test=dict(cfg["test"], weight_file=weight_file),
               experiment=dict(cfg["experiment"], out_dir=str(tmp_path / name)))
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    np.random.seed(7)  # the datasets draw from the global np.random stream
    cli.main([str(path), "--device", "cpu", "--num_threads", str(torch.get_num_threads())])
    return os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _torch_and_jax_files(cfg, tmp_path, rng):
    """The same weights as a port (torch) model file and a JAX one."""
    jax_file, variables = jax_model_file(tmp_path / "jax", cfg, rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(expected(variables), strict=True)
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, model.parameters())
    save_checkpoints(0, model, opt, str(tmp_path))
    return str(tmp_path / "model_00000"), jax_file


def test_test_entry_point_reads_jax_files_and_evaluates_bfloat16_configs_in_float32(
        tmp_path, rng):
    """``python -m nsdp_tpu_torch.test`` writes the same bytes from a torch
    and a JAX model file of the same weights, and from a config that adds
    ``compute_dtype: bfloat16`` (the shipped pair evaluates in float32, as
    ``test.py`` does through ``make_fast_predict``)."""
    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=1, n_frames=3,
                                    n_surface=200, n_space=200)
    cfg = synthetic_config(fx)
    torch_file, jax_file = _torch_and_jax_files(cfg, tmp_path, rng)
    base = _tree(_run_cli(port_test, cfg, torch_file, tmp_path, "torch"))
    assert any("deformed" in key for key in base)
    assert _tree(_run_cli(port_test, cfg, jax_file, tmp_path, "jax")) == base
    bf16 = dict(cfg, model=dict(cfg["model"], compute_dtype="bfloat16"))
    assert _tree(_run_cli(port_test, bf16, jax_file, tmp_path, "bf16")) == base


def test_run_entry_point_reads_jax_files_and_evaluates_bfloat16_configs_in_float32(
        tmp_path, rng):
    """The same for ``python -m nsdp_tpu_torch.run`` on the TOSCA-style
    fixture."""
    fx = generate_userhandle_dataset(str(tmp_path / "data"))
    cfg = synthetic_config(fx, model_type="arbitrary", arbitrary=True)
    cfg["data"].update(type="tosca", mesh_file="model_normalized.obj",
                       userhandle=dict(HEAD_HANDLE))
    cfg["test"].update(iden_split="identity_unseen", motion_split="test_unseen_identities",
                       generate_pointcloud=False)
    torch_file, jax_file = _torch_and_jax_files(cfg, tmp_path, rng)
    base = _tree(_run_cli(port_run, cfg, torch_file, tmp_path, "torch"))
    assert base
    bf16 = dict(cfg, model=dict(cfg["model"], compute_dtype="bfloat16"))
    assert _tree(_run_cli(port_run, bf16, jax_file, tmp_path, "bf16")) == base
