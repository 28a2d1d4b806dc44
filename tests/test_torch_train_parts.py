"""The pieces of the port's training entry point, on the CPU: ``watch_stats``
(against ``nsdp_tpu``'s on the same weights and batch), the train step that
leaves its loss on the device, ``AsyncCheckpointer``, ``trace_steps`` /
``StepTimer``, ``print_num_parameters``, ``save_experiment_params`` and the
logger's watch half (against the JAX package's).
"""

import argparse
import copy
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.training import make_steps as jax_make_steps
from nsdp_tpu.training import optimizer_factory as jax_optimizer_factory
from nsdp_tpu.training import print_num_parameters as jax_print_num_parameters
from nsdp_tpu.training.state import TrainState
from nsdp_tpu.utils.config import save_experiment_params as jax_save_experiment_params
from nsdp_tpu.utils.logger import watch_log_dict as jax_watch_log_dict
from nsdp_tpu_torch.training import (
    load_best_checkpoints,
    load_checkpoints,
    make_steps,
    optimizer_factory,
)
from nsdp_tpu_torch.training import checkpoints as ckpt
from nsdp_tpu_torch.training.async_ckpt import AsyncCheckpointer
from nsdp_tpu_torch.training.optim import print_num_parameters
from nsdp_tpu_torch.utils import profiling
from nsdp_tpu_torch.utils.config import save_experiment_params
from nsdp_tpu_torch.utils.logger import StatsLogger, WandB, watch_log_dict
from tests.test_torch_training import batches, config, jax_variables, port_model

TRAIN_CFG = {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-2}


def trained(model_type, steps=1, **kwargs):
    """A port model after ``steps`` train steps -> (model, optimizer, steps)."""
    model = port_model(model_type)
    _, opt = optimizer_factory(TRAIN_CFG, model.parameters())
    fns = make_steps(model, model_type, opt, device="cpu", **kwargs)
    for batch in batches(5, steps, masked=True):
        fns["train_step"](batch, 1e-3)
    return model, opt, fns


def state_of(model, opt):
    """Everything a step can change: parameters, buffers, every ``.grad``
    and the optimizer's state, copied."""
    return (copy.deepcopy(model.state_dict()),
            [None if p.grad is None else p.grad.clone() for p in model.parameters()],
            copy.deepcopy(opt.state_dict()), model.training)


def assert_same_state(a, b):
    (sd_a, grads_a, opt_a, mode_a), (sd_b, grads_b, opt_b, mode_b) = a, b
    assert mode_a == mode_b
    for k, v in sd_a.items():
        assert torch.equal(v, sd_b[k]), k
    for g, h in zip(grads_a, grads_b):
        assert (g is None and h is None) or torch.equal(g, h)
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for k, v in opt_a["state"].items():
        for name, t in v.items():
            assert torch.equal(t, opt_b["state"][k][name]), (k, name)


@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_watch_stats_keeps_the_model_and_matches_jax(model_type):
    """After a train step (so ``.grad`` and Adam's moments exist), in eval
    mode: ``watch_stats`` changes nothing, and its norms are the JAX
    package's on the same weights and batch."""
    model, opt, steps = trained(model_type)
    model.eval()
    batch = batches(6, 1, masked=True)[0]
    before = state_of(model, opt)
    (p_top, p_leaves), (g_top, g_leaves) = steps["watch_stats"](batch)
    assert_same_state(before, state_of(model, opt))

    params, stats = jax_variables(model)
    _, tx = jax_optimizer_factory(TRAIN_CFG)
    jsteps = jax_make_steps(jax_build_model(config(model_type)), model_type, tx)
    state = TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    (jp_top, jp_leaves), (jg_top, jg_leaves) = jsteps["watch_stats"](
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    names = {"forward": {"encoder", "decoder"},
             "arbitrary": {"model_canonicalize", "model_deform"}}[model_type]
    assert set(p_top) == set(g_top) == set(jp_top) == names
    assert len(p_leaves) == len(g_leaves) == len(jp_leaves) == len(list(model.parameters()))
    for name in names:
        np.testing.assert_allclose(p_top[name], float(jp_top[name]), rtol=1e-5)
        np.testing.assert_allclose(g_top[name], float(jg_top[name]), rtol=1e-3)
    np.testing.assert_allclose(np.sort(p_leaves), np.sort(np.asarray(jp_leaves)), rtol=1e-5,
                               atol=1e-7)
    # fc_gamma's second biases have analytically zero gradients: rounding
    # noise on both sides, held at the scale of the largest gradient
    scale = float(np.max(g_leaves))
    np.testing.assert_allclose(np.sort(g_leaves), np.sort(np.asarray(jg_leaves)), rtol=1e-3,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("nan_guard", [False, True])
def test_lazy_train_step_matches_the_default_step(nan_guard):
    """``train_step(batch, lr, fetch=False)`` gives the default step's loss,
    parameters, statistics and optimizer state, bit for bit; without
    ``nan_guard`` its loss is a 0-d tensor, with it a float."""
    runs = []
    for fetch in (True, False):
        model = port_model("forward")
        _, opt = optimizer_factory(TRAIN_CFG, model.parameters())
        steps = make_steps(model, "forward", opt, nan_guard=nan_guard, device="cpu")
        losses = [steps["train_step"](b, 1e-3, fetch=fetch) for b in batches(7, 3)]
        want = float if fetch or nan_guard else torch.Tensor
        assert all(isinstance(x, want) for x in losses)
        runs.append(([float(x) for x in losses], state_of(model, opt)))
    assert runs[0][0] == runs[1][0]
    assert_same_state(runs[0][1], runs[1][1])


@pytest.fixture
def held_writer(monkeypatch):
    """Holds every background write until ``.set()``: the snapshot must
    not change while it waits."""
    gate = threading.Event()
    for name in ("write_checkpoints", "write_best_checkpoints"):
        write = getattr(ckpt, name)

        def held(*args, _write=write):
            assert gate.wait(30)
            _write(*args)

        monkeypatch.setattr(ckpt, name, held)
    return gate


def test_async_checkpointer_writes_the_snapshot(tmp_path, held_writer):
    """``save`` / ``save_best`` write the state as it was when they were
    called: in-place changes to the model and the optimizer (on the CPU,
    where ``.cpu()`` is the same storage) while the write waits do not
    reach the files, which load back bit for bit."""
    model, opt, _ = trained("forward", steps=2)
    snapshot = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())
    checkpointer = AsyncCheckpointer()
    checkpointer.save(3, model, opt, str(tmp_path))
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(1)
        for s in opt.state.values():
            s["exp_avg"].add_(1.0)
            s["exp_avg_sq"].mul_(2.0)
    held_writer.set()
    checkpointer.wait()

    fresh = port_model("forward", seed=1)
    _, fresh_opt = optimizer_factory(TRAIN_CFG, fresh.parameters())
    assert load_checkpoints(fresh, fresh_opt, str(tmp_path)) == 4
    assert_same_state((snapshot[0], [], snapshot[1], True),
                      (fresh.state_dict(), [], fresh_opt.state_dict(), True))

    held_writer.clear()
    checkpointer.save_best(3, model, str(tmp_path), 0.25)
    changed = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(1)
    held_writer.set()
    checkpointer.wait()
    assert load_best_checkpoints(fresh, str(tmp_path)) == (4, 0.25)
    for k, v in changed.items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("raised_by", ["wait", "save"])
def test_async_checkpointer_raises_a_failed_write(tmp_path, raised_by):
    """A write that fails on the background thread is raised by the next
    ``wait()`` or ``save()``, once."""
    model, opt, _ = trained("forward")
    checkpointer = AsyncCheckpointer()
    checkpointer.save(0, model, opt, str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="does not exist"):
        if raised_by == "wait":
            checkpointer.wait()
        else:
            checkpointer.save(1, model, opt, str(tmp_path))
    checkpointer.save(2, model, opt, str(tmp_path))
    checkpointer.wait()
    assert sorted(os.listdir(tmp_path)) == ["model_00002", "opt_00002"]


def test_trace_steps_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace_steps(str(tmp_path / "trace")):
        torch.ones(4).sum()
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith("trace_") and name.endswith(".json")
    assert os.path.getsize(tmp_path / "trace" / name) > 0
    with profiling.trace_steps(None):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == ["trace"]


def test_step_timer(monkeypatch):
    clock = iter([0.0, 0.5, 1.0, 1.5, 2.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(window=3)
    timer.tick()
    assert timer.steps_per_sec == 0.0 and timer.sec_per_step == 0.0
    for _ in range(4):
        timer.tick()
    assert timer.steps_per_sec == pytest.approx(2.0)
    assert timer.sec_per_step == pytest.approx(0.5)


@pytest.mark.parametrize("model_type", ["backward", "arbitrary"])
def test_print_num_parameters_matches_jax(model_type, capsys):
    model = port_model(model_type)
    n = print_num_parameters(model, model_type)
    port_line = capsys.readouterr().out
    assert jax_print_num_parameters(jax_variables(model)[0], model_type) == n
    assert capsys.readouterr().out == port_line


def test_save_experiment_params_matches_jax(tmp_path):
    args = argparse.Namespace(config_file="cfg.yaml", seed=3, best_val_loss=1e13,
                              profile_dir=None)
    cfg = config("forward")
    save_experiment_params(args, "exp", str(tmp_path / "port"), cfg)
    jax_save_experiment_params(args, "exp", str(tmp_path / "jax"), cfg)
    with open(tmp_path / "port" / "params.json") as f, open(tmp_path / "jax" / "params.json") as g:
        assert f.read() == g.read()


def test_watch_logging_matches_jax():
    """``watch_log_dict`` as the JAX package's; ``WandB.log_watch`` logs it
    with histograms, ``commit=False``."""
    norms = ({"encoder": 2.0, "decoder": 3.0}, np.array([1.0, 0.5], np.float32))
    grads = ({"encoder": 0.25, "decoder": 0.125}, np.array([0.1, 0.2], np.float32))
    assert watch_log_dict(norms, grads) == jax_watch_log_dict(norms, grads)

    logged = []

    class FakeWandb:
        class Histogram:
            def __init__(self, seq):
                self.seq = list(seq)

        @staticmethod
        def log(values, commit=True):
            logged.append((values, commit))

    StatsLogger.reset()
    wb = WandB.instance()
    assert StatsLogger.instance() is wb
    wb.log_watch(norms, grads)  # before init: no wandb, nothing logged
    assert logged == []
    wb._wandb = FakeWandb
    wb.log_watch(norms, grads)
    ((values, commit),) = logged
    assert commit is False
    assert values["param_norm/decoder"] == 3.0 and values["grad_norm/encoder"] == 0.25
    assert values["grad_leaf_norms"].seq == pytest.approx([0.1, 0.2])
    StatsLogger.reset()
