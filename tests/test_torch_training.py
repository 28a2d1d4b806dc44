"""The port's training (``nsdp_tpu_torch.training``) == the JAX package's, on
the CPU: stage-1 step trajectories, the optimizer and its schedule,
``nan_guard``, checkpoints and partial loads.  Stage 2 is in
``tests/test_torch_training_stage2.py``.

The JAX side runs ``nsdp_tpu.training.make_steps`` at ``fused_attention:
false``; the JAX package's own ``tests/test_fused_training.py`` holds its
fused path to that one.  Both sides start from the same weights (the port's
``state_dict`` through the JAX package's ``translate_state_dict``) and take
the same batches.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.training import make_steps as jax_make_steps
from nsdp_tpu.training import optimizer_factory as jax_optimizer_factory
from nsdp_tpu.training.checkpoints import load_model_variables
from nsdp_tpu.training.state import TrainState
from nsdp_tpu.utils.torch_convert import translate_state_dict
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.training import (
    load_best_checkpoints,
    load_checkpoints,
    load_subnetwork,
    make_steps,
    optimizer_factory,
    save_best_checkpoints,
    save_checkpoints,
)

ENC_KW = dict(npoints_per_layer=[24, 12, 6], nneighbor=5, nneighbor_reduced=4,
              nfinal_transformers=1, d_transformer=8, d_reduced=6, full_SA=True)
DEC_KW = dict(dim_inp=8, dim=8, nneigh=4, hidden_dim=8, n_blocks=1, out_dim=3)


def config(model_type):
    return {"model": {"type": model_type, "use_normals": False, "encoder": "pointransformer",
                      "encoder_kwargs": ENC_KW, "decoder": "crossatten", "decoder_kwargs": DEC_KW}}


def batches(seed, n_steps, B=2, N=24, Q=10, masked=False):
    """Seeded numpy batches; ``masked`` pads the last points of each cloud
    (at the origin, with a ``surface_valid_mask``)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        src = rng.randn(B, N, 3).astype(np.float32)
        tgt = rng.randn(B, N, 3).astype(np.float32)
        handle = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
        inputs = np.concatenate([src, tgt * handle, handle], -1)
        batch = {"space_samples_src": rng.randn(B, Q, 3).astype(np.float32),
                 "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32)}
        if masked:
            valid = np.ones((B, N), np.float32)
            valid[0, -5:] = 0.0
            valid[1, -3:] = 0.0
            inputs = inputs * valid[..., None]
            batch["surface_valid_mask"] = valid
        batch["surface_samples_inputs"] = inputs
        out.append(batch)
    return out


def port_model(model_type, seed=0, cfg=None):
    return init_random(build_model(cfg or config(model_type), device="cpu"), seed)


def jax_variables(model):
    """The port's weights as JAX variables (the JAX package's own torch ->
    flax key rules)."""
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    params, stats = translate_state_dict(sd)
    return unflatten_dict(params), unflatten_dict(stats)


def is_gamma_second_bias(path):
    """fc_gamma's second bias: analytically zero gradient (a bias shared by
    every slot cancels in the slot softmax), so Adam moves it by sign noise."""
    return "fc_gamma" in "/".join(path) and path[-2:] == ("fc1", "bias")


def assert_trees_close(jax_tree, port_tree, atol, loose_atol, what):
    want, got = flatten_dict(jax_tree), flatten_dict(port_tree)
    assert sorted(want) == sorted(got), what
    for path, v in want.items():
        tol = loose_atol if is_gamma_second_bias(path) else atol
        np.testing.assert_allclose(got[path], np.asarray(v), rtol=0, atol=tol,
                                   err_msg=f"{what}: {'/'.join(path)}")


def assert_first_moments_close(model, opt, state):
    """Adam's first moments, a fixed linear combination of the gradients of
    every step taken, agree: the gradients themselves are held, not only the
    parameters (which one Adam step moves by about ``lr`` whatever the
    gradient)."""
    mu = {name: opt.state[p]["exp_avg"].numpy() for name, p in model.named_parameters()}
    want = flatten_dict(state.opt_state[-1].mu)
    got = flatten_dict(unflatten_dict(translate_state_dict(mu)[0]))
    assert sorted(want) == sorted(got)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for path, v in want.items():
        np.testing.assert_allclose(got[path], np.asarray(v), rtol=2e-3, atol=1e-5 * scale,
                                   err_msg="/".join(path))


def train_both(model_type, stream, train_cfg, cfg=None):
    """The same steps on both sides -> (port losses, JAX losses, port model,
    JAX state).  The learning rate steps per epoch with step == epoch.
    ``cfg``: the model config (default: the shipped architecture at small
    widths, ``config(model_type)``)."""
    cfg = cfg or config(model_type)
    model = port_model(model_type, cfg=cfg)
    params, stats = jax_variables(model)
    schedule, opt = optimizer_factory(train_cfg, model.parameters())
    steps = make_steps(model, model_type, opt, device="cpu")
    jschedule, tx = jax_optimizer_factory(train_cfg)
    jsteps = jax_make_steps(jax_build_model(cfg), model_type, tx)
    state = TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    losses, jlosses = [], []
    for epoch, batch in enumerate(stream):
        assert schedule.get_learning_rate(epoch) == jschedule.get_learning_rate(epoch)
        losses.append(steps["train_step"](batch, schedule.get_learning_rate(epoch)))
        state, loss = jsteps["train_step"](
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jschedule.get_learning_rate(epoch))
        jlosses.append(float(loss))
    return losses, jlosses, model, opt, state


@pytest.mark.parametrize("model_type", ["forward", "backward"])
def test_stage1_steps_match_jax(model_type):
    """3 steps, Adam with weight decay, the rate halved after 2 epochs."""
    n, lr = 3, 1e-3
    cfg = {"optimizer": "Adam", "lr": lr, "weight_decay": 1e-2, "lr_step": 2, "lr_decay": 0.5}
    losses, jlosses, model, opt, state = train_both(model_type, batches(1, n), cfg)
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4, atol=1e-5)
    assert_first_moments_close(model, opt, state)
    params, stats = jax_variables(model)
    assert_trees_close(state.params, params, 2e-4, 2 * lr * n, "params")
    assert_trees_close(state.batch_stats, stats, 1e-4, 1e-4, "batch_stats")


@pytest.mark.parametrize("cfg", [
    {"optimizer": "Adam", "lr": 1e-2, "weight_decay": 0.1, "clip_grad": 0.5,
     "lr_step": 2, "lr_decay": 0.5},
    {"optimizer": "SGD", "lr": 1e-1, "momentum": 0.8, "weight_decay": 0.05,
     "lr_step": 3, "lr_decay": 0.1},
], ids=["adam_decay_clip", "sgd_momentum"])
def test_optimizer_matches_optax(cfg):
    rng = np.random.RandomState(2)
    init = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (2.0 * rng.randn(*v.shape)).astype(np.float32) for k, v in init.items()}
             for _ in range(5)]
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    schedule, opt = optimizer_factory(cfg, list(tensors.values()))
    jschedule, tx = jax_optimizer_factory(cfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    for epoch, g in enumerate(grads):
        lr = schedule.get_learning_rate(epoch)
        assert lr == pytest.approx(cfg["lr"] * cfg["lr_decay"] ** (epoch // cfg["lr_step"]))
        assert lr == jschedule.get_learning_rate(epoch)
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, jax.tree.map(lambda u: -lr * u, updates))
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_nan_guard_keeps_the_state():
    model = port_model("forward")
    _, opt = optimizer_factory({"lr": 1e-3}, model.parameters())
    steps = make_steps(model, "forward", opt, nan_guard=True, device="cpu")
    good, bad = batches(3, 2)
    steps["train_step"](good, 1e-3)
    bad["space_samples_tgt"][0, 0, 0] = np.nan
    before = copy.deepcopy(model.state_dict())
    opt_before = copy.deepcopy(opt.state_dict())
    loss = steps["train_step"](bad, 1e-3)
    assert np.isnan(loss)
    for k, v in model.state_dict().items():  # parameters and every BatchNorm buffer
        assert torch.equal(v, before[k]), k
    for k, v in opt.state_dict()["state"].items():
        for name, t in v.items():
            assert torch.equal(t, opt_before["state"][k][name]), (k, name)
    assert np.isfinite(steps["train_step"](good, 1e-3))


def test_validate_and_predict():
    model = port_model("backward")
    _, opt = optimizer_factory({"lr": 1e-3}, model.parameters())
    steps = make_steps(model, "backward", opt, device="cpu")
    (batch,) = batches(4, 1)
    loss = steps["validate_step"](batch)
    pred = steps["predict"](batch["space_samples_src"], batch["surface_samples_inputs"])
    want = 0.5 * ((pred.numpy() - batch["space_samples_tgt"]) ** 2).sum(-1).mean()
    assert loss == pytest.approx(float(want), rel=1e-5)
    # the masked mean over real samples equals the mean over the real rows
    masked = steps["validate_step_masked"](batch, np.array([1.0, 0.0], np.float32))
    first = {k: v[:1] for k, v in batch.items()}
    assert masked == pytest.approx(steps["validate_step"](first), rel=1e-5)
    assert not model.training


def test_checkpoints_names_resume_and_jax_load(tmp_path):
    model = port_model("forward")
    cfg = {"optimizer": "Adam", "lr": 1e-3}
    _, opt = optimizer_factory(cfg, model.parameters())
    steps = make_steps(model, "forward", opt, device="cpu")
    first, second = batches(5, 2)
    steps["train_step"](first, 1e-3)
    save_checkpoints(3, model, opt, str(tmp_path))
    save_best_checkpoints(3, model, str(tmp_path), 0.25)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model_00003", "modelbest_00003_0.250000", "opt_00003"]

    # the JAX package reads the port's model file
    params, stats = jax_variables(model)
    other_p, other_s = jax_variables(port_model("forward", seed=9))
    template = TrainState(params=other_p, batch_stats=other_s, opt_state=None, step=0)
    loaded = load_model_variables(str(tmp_path / "model_00003"), template)
    assert_trees_close(loaded.params, params, 0.0, 0.0, "params")
    assert_trees_close(loaded.batch_stats, stats, 0.0, 0.0, "batch_stats")

    # resume from the highest epoch; the next step matches
    resumed = port_model("forward", seed=9)
    _, ropt = optimizer_factory(cfg, resumed.parameters())
    assert load_checkpoints(resumed, ropt, str(tmp_path)) == 4
    rsteps = make_steps(resumed, "forward", ropt, device="cpu")
    assert rsteps["train_step"](second, 1e-3) == steps["train_step"](second, 1e-3)
    for k, v in model.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k
    best = port_model("forward", seed=9)
    assert load_best_checkpoints(best, str(tmp_path)) == (4, 0.25)
    assert load_checkpoints(best, ropt, str(tmp_path / "missing")) is None


def test_load_subnetwork_grafts_stage1_checkpoints(tmp_path):
    fwd, bwd = port_model("forward", seed=1), port_model("backward", seed=2)
    for name, net in (("fwd", fwd), ("bwd", bwd)):
        (tmp_path / name).mkdir()
        _, opt = optimizer_factory({"lr": 1e-3}, net.parameters())
        save_checkpoints(0, net, opt, str(tmp_path / name))
    arb = port_model("arbitrary", seed=3)
    load_subnetwork(arb, str(tmp_path / "fwd" / "model_00000"), "model_deform")
    load_subnetwork(arb, str(tmp_path / "bwd" / "model_00000"), "model_canonicalize")
    for branch, net in ((arb.model_deform, fwd), (arb.model_canonicalize, bwd)):
        for k, v in net.state_dict().items():
            assert torch.equal(branch.state_dict()[k], v), k
    with pytest.raises(ValueError, match="lacks"):  # a backward net lacks enc_sdf
        load_subnetwork(arb, str(tmp_path / "bwd" / "model_00000"), "model_deform")
    with pytest.raises(KeyError):
        load_subnetwork(arb, str(tmp_path / "fwd" / "model_00000"), "encoder")


def test_new_resnet_blocks_start_as_the_identity():
    """``fc_1`` starts at zero, as the reference's (nsdp_tpu/nn/blocks.py:716-721)."""
    from nsdp_tpu_torch.nn.blocks import ResnetBlockFC

    block = ResnetBlockFC(6)
    assert not block.fc_1.weight.any()
    x = torch.randn(4, 6)
    assert torch.allclose(block(x), x + block.fc_1.bias)
