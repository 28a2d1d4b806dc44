"""The port resumes from the JAX package's optimizer files (``opt_*``).

``nsdp_tpu.training.checkpoints.save_checkpoints`` writes the optax state
as flax msgpack; ``nsdp_tpu_torch.training.checkpoints.load_checkpoints``
reads it into the torch optimizer (``read_optimizer_state``).  On
``synthetic_config``'s model with JAX-initialised weights, for Adam, Adam
with ``clip_grad`` and ``weight_decay`` (two stateless optax stages ahead of
Adam's) and SGD with momentum:

* the loaded state equals ``mu``/``nu``/``count``/``trace`` bit for bit,
  read back onto the JAX tree by the JAX package's own key rules
  (``nsdp_tpu.utils.torch_convert.translate_state_dict``);
* one more update with the same gradient lands within
  ``tests/test_torch_training.py::test_optimizer_matches_optax``'s
  ``rtol=1e-5, atol=1e-6`` of optax's.

And ``python -m nsdp_tpu_torch.train --device cpu`` resumes a directory that
``train.py`` wrote, at the JAX run's epoch + 1, from its files bit for bit.
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

import nsdp_tpu_torch.train as port_train
from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.training import create_train_state
from nsdp_tpu.training import optimizer_factory as jax_optimizer_factory
from nsdp_tpu.training.checkpoints import save_checkpoints as jax_save_checkpoints
from nsdp_tpu.utils.logger import StatsLogger as JaxStatsLogger
from nsdp_tpu.utils.torch_convert import translate_state_dict
from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config
from nsdp_tpu_torch.models import build_model
from nsdp_tpu_torch.training import load_checkpoints, make_steps, optimizer_factory
from nsdp_tpu_torch.utils.convert import from_jax_variables
from nsdp_tpu_torch.utils.msgpack_reader import read_flax_optimizer

REPO = Path(__file__).resolve().parents[1]
OPTIMIZERS = {
    "adam": {"optimizer": "Adam", "lr": 1e-2},
    "adam_clip_decay": {"optimizer": "Adam", "lr": 1e-2, "clip_grad": 0.5, "weight_decay": 0.1},
    "sgd": {"optimizer": "SGD", "lr": 1e-1, "momentum": 0.8},
}
MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}


@pytest.fixture(scope="module")
def jax_model():
    """``synthetic_config``'s forward model, its JAX variables initialised
    -> (config, params, batch_stats)."""
    cfg = synthetic_config({"dataset_dir": "unused", "split_dir": "unused"})
    model = jax_build_model(cfg)
    example = (jnp.zeros((1, 8, 3)), jnp.zeros((1, 16, 7)))
    _, tx = jax_optimizer_factory(OPTIMIZERS["adam"])
    state = create_train_state(model, jax.random.PRNGKey(0), example, tx)
    return cfg, jax.device_get(state.params), jax.device_get(state.batch_stats)


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), params)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _on_jax_tree(named):
    """``{port parameter name: tensor}`` on the JAX params tree (flat), by
    the JAX package's own key rules."""
    params, _ = translate_state_dict({k: v.detach().numpy() for k, v in named.items()})
    return params


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_opt_file_loads_and_steps_as_optax(jax_model, tmp_path, name):
    cfg, params, batch_stats = jax_model
    config = OPTIMIZERS[name]
    _, tx = jax_optimizer_factory(config)
    opt_state = tx.init(params)
    for seed in range(3):  # three updates: non-trivial moments and count
        updates, opt_state = tx.update(_grads(params, seed), opt_state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -config["lr"] * u, updates))
    state = type("TrainState", (), dict(params=params, batch_stats=batch_stats,
                                        opt_state=opt_state, step=jnp.int32(3)))
    jax_save_checkpoints(0, state, str(tmp_path))
    assert read_flax_optimizer(str(tmp_path / "opt_00000"))[1] == 3

    model = build_model(cfg, device="cpu")
    _, opt = optimizer_factory(config, model.parameters())
    assert load_checkpoints(model, opt, str(tmp_path)) == 1
    names = dict(model.named_parameters())
    by_param = {n: opt.state[p] for n, p in names.items()}
    stage = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "_fields"))
             if getattr(s, "_fields", ())][0]
    for field in stage._fields:
        if field == "count":
            steps = {float(s["step"]) for s in by_param.values()}
            assert steps == {float(stage.count)} == {3.0}
            assert all(s["step"].dtype == torch.float32 for s in by_param.values())
            continue
        tree = dict(_flat(getattr(stage, field)))
        loaded = _on_jax_tree({n: s[MOMENTS[field]] for n, s in by_param.items()})
        assert sorted(loaded) == sorted(tree), field
        for key, value in tree.items():
            np.testing.assert_array_equal(loaded[key], value, err_msg=f"{field} {key}")

    # one more update with the same gradient on both sides
    grads = _grads(params, 7)
    flat_grads = from_jax_variables(grads, {})
    for n, p in names.items():
        p.grad = flat_grads[n].clone()
    opt.step()
    updates, _ = tx.update(grads, opt_state, params)
    want = optax.apply_updates(params, jax.tree.map(lambda u: -config["lr"] * u, updates))
    got = _on_jax_tree(names)
    for key, value in _flat(want):
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6, err_msg=str(key))


def test_an_optax_state_that_does_not_fit_is_refused(jax_model, tmp_path):
    """An optax state that does not fit the optimizer is refused, naming
    both."""
    cfg, params, batch_stats = jax_model
    _, tx = jax_optimizer_factory(OPTIMIZERS["sgd"])
    state = type("TrainState", (), dict(params=params, batch_stats=batch_stats,
                                        opt_state=tx.init(params), step=jnp.int32(0)))
    jax_save_checkpoints(0, state, str(tmp_path))
    model = build_model(cfg, device="cpu")
    _, adam = optimizer_factory(OPTIMIZERS["adam"], model.parameters())
    with pytest.raises(ValueError, match="trace.*Adam"):
        load_checkpoints(model, adam, str(tmp_path))


def _jax_train():
    spec = importlib.util.spec_from_file_location("jax_train_cli", REPO / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_resumes_a_train_py_directory(tmp_path, monkeypatch):
    """``train.py`` trains one epoch; the port's CLI, given 2 epochs on the
    same directory, resumes at epoch 2 from ``model_00000``/``opt_00000``:
    the model and the Adam state before its first step are the files' bit
    for bit (the BatchNorm counters, which flax does not keep, aside), and
    it trains epoch 2 only."""
    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=1, n_frames=3, n_surface=200,
                                    n_space=200)
    cfg = synthetic_config(fx)
    cfg["experiment"]["out_dir"] = str(tmp_path / "out")
    cfg["training"].update(epochs=1, save_frequency=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = [str(path), "--seed", "0", "--num_workers", "0", "--matmul_precision", "highest"]
    JaxStatsLogger.reset()
    _jax_train().main(argv)
    directory = tmp_path / "out" / cfg["experiment"]["name"]
    assert {"model_00000", "opt_00000"} <= set(os.listdir(directory))
    jax_files = {n: (directory / n).read_bytes() for n in ("model_00000", "opt_00000")}

    seen = {}

    def recording_steps(model, model_type, optimizer, **kwargs):
        steps = make_steps(model, model_type, optimizer, **kwargs)
        train = steps["train_step"]

        def train_step(batch, lr, fetch=True):
            if "model" not in seen:
                seen["model"] = {k: v.clone() for k, v in model.state_dict().items()}
                seen["opt"] = {n: {k: v.clone() for k, v in optimizer.state[p].items()}
                               for n, p in model.named_parameters()}
            return train(batch, lr, fetch)

        steps["train_step"] = train_step
        return steps

    monkeypatch.setattr(port_train, "make_steps", recording_steps)
    cfg["training"]["epochs"] = 2
    path.write_text(yaml.safe_dump(cfg))
    port_train.main([*argv, "--device", "cpu", "--num_threads", str(torch.get_num_threads())])
    assert "model_00001" in os.listdir(directory)
    for n in ("model_00000", "opt_00000"):
        assert (directory / n).read_bytes() == jax_files[n]  # read, not rewritten
    with open(directory / "stats.txt") as f:
        epochs = {int(line.split()[1]) for line in f if line.startswith("epoch: ")}
    assert epochs - {-1} == {2}

    # the files as flax reads them, held on the JAX tree by the JAX
    # package's own key rules
    with open(directory / "model_00000", "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    with open(directory / "opt_00000", "rb") as f:
        (adam,) = [s for s in serialization.msgpack_restore(f.read())["opt_state"].values() if s]
    params, stats = translate_state_dict({k: v.numpy() for k, v in seen["model"].items()})
    for got, col in ((params, "params"), (stats, "batch_stats")):
        want = dict(_flat(variables[col]))
        assert sorted(got) == sorted(want), col
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"{col} {key}")
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = _on_jax_tree({n: s[key] for n, s in seen["opt"].items()})
        for path, value in _flat(adam[field]):
            np.testing.assert_array_equal(got[path], value, err_msg=f"{field} {path}")
    assert {float(s["step"]) for s in seen["opt"].values()} == {float(adam["count"])} != {0.0}
