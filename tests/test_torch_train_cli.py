"""The port's training entry point == ``train.py`` on the CPU.

``nsdp_tpu_torch.train.main`` (``--device cpu``, the plain PyTorch path)
against ``train.py`` (the flax path), both at ``--matmul_precision
highest``, ``--seed 0`` and ``--num_workers 0`` on the synthetic fixture
with ``synthetic_config``'s tiny model, both starting from the weights of
ONE model file that the port's ``training/checkpoints.py`` writes (or, in
stage 2, from the same stage-1 files of the port).  The global ``np.random``
is seeded by both CLIs, and both draw the same items, so both see the same
batches.  Held within the tolerances stated:

* every float of the ``stats.txt`` progress lines (losses, running means)
  within ``LINES_TOL`` -- except ``steps_per_sec``, a wall-clock rate of
  each run's own machine, which must only be there on both sides;
* every ``model_*`` file within the tolerances of
  ``tests/test_torch_training.py::test_stage1_steps_match_jax`` (the JAX
  msgpack read through ``nsdp_tpu.training.checkpoints`` and carried over
  with ``from_jax_variables``);
* ``modelbest_*`` at the same epoch, its loss within ``LINES_TOL``;
  ``params.json`` with the same keys but the port's ``device``;
* the wandb watch logs (a stub ``wandb`` module): as many, at the same
  epochs, the norms within ``LINES_TOL``.
"""

import importlib.util
import json
import os
import re
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import nsdp_tpu_torch.train as port_train
from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.training import create_train_state
from nsdp_tpu.training import optimizer_factory as jax_optimizer_factory
from nsdp_tpu.utils.logger import StatsLogger as JaxStatsLogger
from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.training import (
    make_steps,
    optimizer_factory,
    read_state_dict,
    save_checkpoints,
)
from nsdp_tpu_torch.utils.convert import from_jax_variables
from nsdp_tpu_torch.utils.logger import watch_log_dict

REPO = Path(__file__).resolve().parents[1]
LINES_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_entry_points.py:195
PARAMS_ATOL, STATS_ATOL = 2e-4, 1e-4  # tests/test_torch_training.py:141-146
LR = 1e-3  # synthetic_config's


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """5 frames: 5 training pairs (2 batches of 2 an epoch) and 5
    validation pairs (the last batch padded) for a stage-1 model."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    return generate_synthetic_dataset(
        str(root), n_identities=1, n_motions_per_identity=1, n_frames=5,
        n_surface=200, n_space=200,
    )


def _jax_train():
    spec = importlib.util.spec_from_file_location("jax_train_cli", REPO / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _weight_file(cfg, directory, seed=3):
    """A model file of the port's checkpointing with seeded weights whose
    deformed positions are O(1) (``out_scale``)."""
    directory.mkdir(parents=True, exist_ok=True)
    model = init_random(build_model(cfg, device="cpu"), seed, out_scale=0.01)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    save_checkpoints(0, model, opt, str(directory))
    return str(directory / "model_00000")


def _run(side, cfg, root, extra=()):
    """Run ``side``'s CLI on ``cfg`` with its outputs under ``root/side``
    -> (experiment directory, what ``main`` returned)."""
    cfg = dict(cfg, experiment=dict(cfg["experiment"], out_dir=str(root / side)))
    path = root / f"{side}.yaml"
    root.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    argv = [str(path), "--matmul_precision", "highest", "--seed", "0", "--num_workers", "0",
            *extra]
    JaxStatsLogger.reset()
    if side == "jax":
        out = _jax_train().main(argv)
    else:
        out = port_train.main([*argv, "--device", "cpu", "--num_threads",
                               str(torch.get_num_threads())])
    return root / side / cfg["experiment"]["name"], out


def _progress(path):
    """The progress lines of ``stats.txt``: (epoch, batch, {name: value})."""
    out = []
    with open(path) as f:
        for line in f:
            m = re.match(r"epoch: (-?\d+) - batch: (\d+) - (.*)$", line.strip())
            if m:
                values = dict(kv.split(": ") for kv in m.group(3).split(" - "))
                out.append((int(m.group(1)), int(m.group(2)),
                            {k: float(v) for k, v in values.items()}))
    return out


def _compare_stats(jax_dir, port_dir):
    want, got = _progress(jax_dir / "stats.txt"), _progress(port_dir / "stats.txt")
    assert len(want) == len(got) > 0
    for (je, jb, jv), (pe, pb, pv) in zip(want, got):
        assert (je, jb, sorted(jv)) == (pe, pb, sorted(pv))
        for k, v in jv.items():
            if k != "steps_per_sec":
                np.testing.assert_allclose(pv[k], v, **LINES_TOL, err_msg=f"{je}/{jb} {k}")
    return want


def _jax_model_file(path, cfg):
    """A model file of the JAX package as the port's state dict."""
    model = jax_build_model(cfg)
    n, q = 16, 8
    inputs = jnp.zeros((1, n, 7))
    if cfg["model"]["type"] == "arbitrary":
        example = (jnp.zeros((1, q, 3)), inputs[..., 0:3], inputs[..., 3:6], inputs[..., 6:7])
    else:
        example = (jnp.zeros((1, q, 3)), inputs)
    state = create_train_state(model, jax.random.PRNGKey(0), example,
                               jax_optimizer_factory(cfg["training"])[1])
    with open(path, "rb") as f:
        restored = serialization.from_bytes(
            {"params": state.params, "batch_stats": state.batch_stats}, f.read())
    return from_jax_variables(restored["params"], restored["batch_stats"])


def _vanishing(cfg, state):
    """The parameters whose gradient vanishes analytically: fc_gamma's
    second bias (shared by every slot of the slot softmax) and every
    parameter whose output a train-mode BatchNorm cancels (a bias, or a
    BatchNorm's shift, right before one).  Found in float64, where their
    gradients are below 1e-9 of the largest, on a random batch."""
    model = build_model(cfg, device="cpu").double()
    model.load_state_dict(state)
    model.train()
    rng = np.random.RandomState(0)
    n = cfg["model"]["encoder_kwargs"]["npoints_per_layer"][0]
    src = torch.from_numpy(rng.randn(2, n, 3))
    handle = torch.from_numpy((rng.rand(2, n, 1) > 0.5).astype(np.float64))
    tgt = torch.from_numpy(rng.randn(2, n, 3)) * handle
    points = torch.from_numpy(rng.randn(2, 16, 3))
    if cfg["model"]["type"] == "arbitrary":
        pred = model(points, src, tgt, handle)
    else:
        pred = model(points, torch.cat([src, tgt, handle], -1))
    loss = torch.mean(0.5 * torch.sum((pred - torch.from_numpy(rng.randn(2, 16, 3))) ** 2, -1))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    scale = max(float(g.abs().max()) for g in grads if g is not None)
    return {k for k, g in zip(names, grads) if g is None or float(g.abs().max()) <= 1e-9 * scale}


def _compare_models(jax_dir, port_dir, cfg, n_steps):
    """Every ``model_*`` within the tolerances of
    ``tests/test_torch_training.py``; a parameter whose gradient vanishes
    analytically is rounding noise that Adam normalises, up to ``lr`` a step
    on each side, so it is held to ``2 lr`` a step."""
    names = sorted(f for f in os.listdir(jax_dir) if f.startswith("model_"))
    assert names == sorted(f for f in os.listdir(port_dir) if f.startswith("model_"))
    loose = None
    for name in names:
        want = _jax_model_file(jax_dir / name, cfg)
        got = read_state_dict(str(port_dir / name))
        assert sorted(want) == sorted(got), name
        if loose is None:
            loose = _vanishing(cfg, got)
            assert any("fc_gamma.2.bias" in k for k in loose)
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue  # the JAX variables carry no count
            stat = k.endswith(("running_mean", "running_var"))
            atol = STATS_ATOL if stat else 2 * LR * n_steps if k in loose else PARAMS_ATOL
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0, atol=atol,
                                       err_msg=f"{name}: {k}")


def _names(directory):
    """The file names in ``directory``, ``modelbest_*`` without its loss
    (:func:`_best` holds the loss)."""
    return sorted(re.sub(r"^(modelbest_\d{5})_.*$", r"\1", f) for f in os.listdir(directory))


def _best(directory):
    (name,) = [f for f in os.listdir(directory) if f.startswith("modelbest_")]
    epoch, loss = re.match(r"modelbest_(\d{5})_([\d.]+)$", name).groups()
    return int(epoch), float(loss)


@pytest.fixture(scope="module")
def stage1(fixture, tmp_path_factory):
    """Both CLIs, 2 epochs of the forward net from one weight file ->
    (config, JAX directory, port directory, port times)."""
    root = tmp_path_factory.mktemp("stage1")
    cfg = synthetic_config(fixture)
    cfg["training"]["weight_file"] = _weight_file(cfg, root / "weights")
    jax_dir, _ = _run("jax", cfg, root)
    port_dir, times = _run("port", cfg, root)
    return cfg, jax_dir, port_dir, times


def test_stage1_matches_train_py(stage1):
    cfg, jax_dir, port_dir, times = stage1
    assert _names(jax_dir) == _names(port_dir)
    assert _names(port_dir) == ["model_00000", "model_00001", "modelbest_00001", "opt_00000",
                                "opt_00001", "params.json", "stats.txt"]
    lines = _compare_stats(jax_dir, port_dir)
    # 2 batches an epoch, then 3 validation batches (the last one padded)
    assert [(e, b) for e, b, _ in lines] == [(1, 1), (1, 2), (2, 1), (2, 2),
                                             (-1, 1), (-1, 2), (-1, 3)]
    _compare_models(jax_dir, port_dir, cfg, n_steps=4)
    (je, jl), (pe, pl) = _best(jax_dir), _best(port_dir)
    assert je == pe == 1
    np.testing.assert_allclose(pl, jl, **LINES_TOL)
    with open(jax_dir / "params.json") as f, open(port_dir / "params.json") as g:
        want, got = json.load(f), json.load(g)
    assert set(got) == set(want) | {"device"}
    assert got["config"]["model"] == want["config"]["model"]
    # every part of the loop was timed: 4 steps, 1 validation, 2 saves, 1
    # best, the last wait; no watch without wandb
    assert [len(times[k]) for k in port_train.PARTS] == [4, 4, 4, 0, 1, 4]


def test_resume_matches_train_py(stage1, tmp_path):
    """Both runs resumed to 3 epochs: the third epoch's lines agree."""
    cfg, jax_dir, port_dir, _ = stage1
    cfg = dict(cfg, training=dict(cfg["training"], epochs=3))
    for side, src in (("jax", jax_dir), ("port", port_dir)):
        shutil.copytree(src, tmp_path / side / src.name)
    dirs = {side: _run(side, cfg, tmp_path)[0] for side in ("jax", "port")}
    lines = _compare_stats(dirs["jax"], dirs["port"])
    assert [(e, b) for e, b, _ in lines] == [(3, 1), (3, 2), (-1, 1), (-1, 2), (-1, 3)]
    assert _names(dirs["jax"]) == _names(dirs["port"])
    assert "model_00002" in os.listdir(dirs["port"])


def _recording(monkeypatch):
    """Make ``nsdp_tpu_torch.train`` record its model's state before the
    first step, the batches its train steps and ``watch_stats`` take, and
    its validation steps' (batch, mask) pairs."""
    record = {"train": [], "validation": [], "watch": []}

    def recording_steps(model, *args, **kwargs):
        steps = make_steps(model, *args, **kwargs)
        train, validate = steps["train_step"], steps["validate_step_masked"]
        watch = steps["watch_stats"]

        def train_step(batch, lr, fetch=True):
            if not record["train"]:
                record["first"] = {k: v.clone() for k, v in model.state_dict().items()}
            record["train"].append({k: v.clone() for k, v in batch.items()})
            return train(batch, lr, fetch)

        def validate_step_masked(batch, mask):
            record["validation"].append((dict(batch), mask))
            return validate(batch, mask)

        def watch_stats(batch):
            record["watch"].append({k: v.clone() for k, v in batch.items()})
            return watch(batch)

        steps.update(train_step=train_step, validate_step_masked=validate_step_masked,
                     watch_stats=watch_stats)
        return steps

    monkeypatch.setattr(port_train, "make_steps", recording_steps)
    return record


def _port_model(cfg, state):
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    return model, make_steps(model, cfg["model"]["type"], opt, device="cpu")


def test_stage2_from_stage1_files_matches_train_py(fixture, stage1, tmp_path, monkeypatch):
    """'arbitrary' with ``weight_forward_file`` / ``weight_backward_file``
    set to stage-1 files of the port (the forward net of ``stage1``, a
    backward net trained one epoch by the port's CLI), 2 epochs.

    The port's branches hold the files' weights bit for bit before its
    first step, and the first epoch's three lines agree within
    ``LINES_TOL``.  There the runs part: these stage-1 nets map the surface
    to a canonical blob ~0.01-0.04 across (nearest points ~3e-4 apart),
    where the forward encoder's FPS and kNN sit on near-ties, so rounding
    picks other points on each side and the weights part by ~1e-3 within
    the first epoch.  ``train.py``'s later numbers are held against the
    port's functions at ``train.py``'s own weights instead: epoch 2's first
    loss (``model_00000``, on the batch the port's run took there) and the
    validation lines (``model_00001``, on the port's validation batches)."""
    cfg1, _, port_dir, _ = stage1
    back = dict(cfg1, model=dict(cfg1["model"], type="backward"))
    back["training"] = dict(cfg1["training"], epochs=1,
                            weight_file=_weight_file(back, tmp_path / "weights"))
    back_dir, _ = _run("port", back, tmp_path / "backward")
    cfg = synthetic_config(fixture, model_type="arbitrary", arbitrary=True)
    files = {"model_deform": str(port_dir / "model_00001"),
             "model_canonicalize": str(back_dir / "model_00000")}
    cfg["training"].update(num_sampled_pairs=6, weight_forward_file=files["model_deform"],
                           weight_backward_file=files["model_canonicalize"])
    cfg["validation"]["batch_size"] = 3  # 4 pairs: the second batch padded
    jax_dir, _ = _run("jax", cfg, tmp_path)
    record = _recording(monkeypatch)
    port2_dir, _ = _run("port", cfg, tmp_path)
    assert _names(jax_dir) == _names(port2_dir)

    for branch, path in files.items():
        for k, v in read_state_dict(path).items():
            assert torch.equal(record["first"][f"{branch}.{k}"], v), f"{branch}.{k}"
    want, got = _progress(jax_dir / "stats.txt"), _progress(port2_dir / "stats.txt")
    assert [(e, b) for e, b, _ in want] == [(e, b) for e, b, _ in got] == [
        (1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3), (-1, 1), (-1, 2)]
    for (_, _, jv), (_, _, pv) in zip(want[:3], got[:3]):
        np.testing.assert_allclose(pv["loss"], jv["loss"], **LINES_TOL)

    model, _ = _port_model(cfg, _jax_model_file(jax_dir / "model_00000", cfg))
    model.train()
    batch = record["train"][3]
    inputs = batch["surface_samples_inputs"]
    with torch.no_grad():
        pred = model(batch["space_samples_src"], inputs[..., 0:3], inputs[..., 3:6],
                     inputs[..., 6:7])
    loss = float(torch.mean(0.5 * torch.sum((pred - batch["space_samples_tgt"]) ** 2, -1)))
    np.testing.assert_allclose(loss, want[3][2]["loss"], **LINES_TOL)

    _, steps = _port_model(cfg, _jax_model_file(jax_dir / "model_00001", cfg))
    losses = [steps["validate_step_masked"](b, m) for b, m in record["validation"]]
    np.testing.assert_allclose(np.cumsum(losses) / np.arange(1, len(losses) + 1),
                               [v["loss"] for _, _, v in want[6:]], **LINES_TOL)


def _fake_wandb(logs):
    fake = types.ModuleType("wandb")

    class Histogram:
        def __init__(self, seq):
            self.seq = list(seq)

    def log(values, commit=True):
        if any(k.startswith("param_norm/") for k in values):
            logs.append(values)

    fake.Histogram = Histogram
    fake.login = lambda *a, **kw: None
    fake.init = lambda *a, **kw: None
    fake.log = log
    return fake


def _compare_watch(want, got, grads=True):
    """Two watch logs: the same keys, the top-level norms by name and the
    per-parameter norms (sorted: the two packages order their parameters
    differently) within ``LINES_TOL``; the gradients' only if ``grads``."""
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        if k.startswith("grad") and not grads:
            continue
        if "_norm/" in k:
            np.testing.assert_allclose(got[k], v, **LINES_TOL, err_msg=k)
        else:
            seq = lambda x: getattr(x, "seq", x)  # a stub Histogram or watch_log_dict's list
            np.testing.assert_allclose(sorted(seq(got[k])), sorted(seq(v)), **LINES_TOL, err_msg=k)


def test_wandb_watch_matches_train_py(fixture, tmp_path, monkeypatch):
    """4 epochs, ``logger.log_frequency`` 2: two watch logs a side, at
    epochs 0 and 2.

    Epoch 0's norms agree within ``LINES_TOL``.  At epoch 2 the parameter
    norms do; the two runs' weights then differ by up to ~3e-4 (the
    parameters whose gradient vanishes analytically move by Adam-normalised
    rounding noise), and the encoder's gradient norm differs by a few
    percent between the two weight sets in float64 as well.  So epoch 2's
    gradient norms of ``train.py`` are held against the port's
    ``watch_stats`` at ``train.py``'s weights of that epoch (``model_00002``,
    written after the watch) on the batch the port's run watched."""
    cfg = synthetic_config(fixture)
    cfg["training"]["weight_file"] = _weight_file(cfg, tmp_path / "weights")
    cfg["training"]["epochs"] = 4
    cfg["logger"]["log_frequency"] = 2
    watched = _recording(monkeypatch)["watch"]
    logs, dirs = {}, {}
    for side in ("jax", "port"):
        logs[side] = []
        monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(logs[side]))
        dirs[side], _ = _run(side, cfg, tmp_path, ["--with_wandb_logger"])
    assert len(logs["jax"]) == len(logs["port"]) == len(watched) == 2
    assert {k for k in logs["port"][0] if "_norm/" in k} == {
        "param_norm/encoder", "param_norm/decoder", "grad_norm/encoder", "grad_norm/decoder"}
    _compare_watch(logs["jax"][0], logs["port"][0])
    _compare_watch(logs["jax"][1], logs["port"][1], grads=False)

    _, steps = _port_model(cfg, _jax_model_file(dirs["jax"] / "model_00002", cfg))
    _compare_watch(logs["jax"][1], watch_log_dict(*steps["watch_stats"](watched[1])))
    JaxStatsLogger.reset()


def test_train_raises_without_a_card(fixture, tmp_path, monkeypatch):
    """``--device cuda`` (the default) with no card raises before any file
    is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = synthetic_config(fixture)
    cfg["experiment"]["out_dir"] = str(tmp_path / "out")
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    for argv in ([path], [path, "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_train.main(argv)
    assert not os.path.exists(tmp_path / "out")
