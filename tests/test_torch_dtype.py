"""``model.compute_dtype`` and ``model.remat`` in the port against the JAX
package on the CPU, and K1's narrow-operand mode.

The JAX side runs as its own tests run it here: its fused attention in
interpret mode (``fused_attention: true``, the semantics of the port's one
path).  Tolerances are stated against JAX's own narrow-vs-float32 gap on
the same inputs, the relative L2 distance ``|a - b| / |b|``:

* K1's plain narrow mode against ``fused_vector_attention(compute_dtype=)``:
  at most 1/4 of the gap at the self-attention sites (``exact_self``: the
  same rounding; measured ratios < 0.001), at most 3/4 of it at the cross
  sites, where JAX rounds its split delta ``[x_q - hi | -lo]`` and the port
  ``dx`` itself (measured 0.48 in bfloat16, 0.58 in float16);
* a model's outputs, a train step's loss, its gradients and its updated
  BatchNorm statistics under ``compute_dtype: bfloat16``: at most 1/4 of
  the gap where the port rounds as JAX does all the way to the output
  (measured ratios 0 to 0.13), twice the gap where float32 noise between
  the two (~2e-7) flips a rounding that later layers amplify (the backward
  net's forward, 0.75; single gradient leaves; JAX's split delta on the
  evaluation path, 0.81).

Each test also shows that it tells the narrow mode from float32: the port
in float32 (the control, ``compute_dtype`` unset) fails each limit below 1,
and where the limit is not below 1 the port's own narrow-vs-float32 gap is
within a factor of 2 of JAX's (:func:`moves_as_jax_moves`; the control's
is 0).

``remat: true`` is held bit for bit against ``remat: false`` (the
recompute runs the same float32 operations in the same order on the CPU).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from nsdp_tpu.models import build_model as jax_build_model
from nsdp_tpu.models.deformation import compute_l2_error as jax_l2
from nsdp_tpu.models.fast_predict import make_fast_predict
from nsdp_tpu.ops.attention_pallas import fused_vector_attention as jax_attention
from nsdp_tpu.training.steps import _double_bn_update
from nsdp_tpu.utils.torch_convert import translate_state_dict
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.nn.blocks import BatchNorm
from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.training import make_steps, optimizer_factory
from nsdp_tpu_torch.utils.convert import from_jax_variables
from tests.test_fast_predict import CFG
from tests.test_torch_kernels import _attention_case
from tests.test_torch_models import randomize
from tests.test_torch_pointnet import ablation
from tests.test_torch_training import batches, jax_variables

JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def moves_as_jax_moves(narrow, f32, jax_narrow, jax_f32):
    """The port's narrow mode moves its result from its float32 result as
    far as JAX's moves JAX's, within a factor of 2: a port that ignored the
    dtype moves it not at all."""
    ratio = rel(narrow, f32) / rel(jax_narrow, jax_f32)
    assert 0.5 <= ratio <= 2, ratio


def config(model_type="arbitrary", dtype=None, pair="shipped", **extra):
    cfg = {"model": dict(copy.deepcopy(CFG["model"]), type=model_type, fused_attention=True,
                         **extra)}
    if pair != "shipped":
        cfg = ablation(cfg, pair)
        cfg["model"]["type"] = model_type
    if dtype is not None:
        cfg["model"]["compute_dtype"] = dtype
    return cfg


# ---------------------------------------------------------------- K1's narrow mode


@pytest.mark.parametrize("mode,exact_self,dtype,bound", [
    ("pos_only", True, torch.bfloat16, 0.25),
    ("table", True, torch.bfloat16, 0.25),
    ("proj", True, torch.bfloat16, 0.25),
    ("global", True, torch.bfloat16, 0.25),
    ("global", False, torch.bfloat16, 0.75),
    ("table", True, torch.float16, 0.25),
    ("global", False, torch.float16, 0.75),
])
def test_attention_narrow_mode_matches_jax(mode, exact_self, dtype, bound, rng):
    """The port's plain narrow mode against the TPU kernel's
    ``compute_dtype`` in interpret mode (module docstring for the bounds)."""
    nq = 64 if mode == "global" else 25
    a, w = _attention_case(rng, mode, False, B=1, M=64, D=16, k=8, nq=nq)
    j = lambda x: None if x is None else jnp.asarray(x)
    named = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a", "k")
    kw = {key: j(v) for key, v in a.items() if key not in named}
    args = [j(a[key]) for key in named[:-1]] + [j(x) for x in w]
    run = lambda cd: np.asarray(jax_attention(*args, k=a["k"], tile=128, interpret=True,
                                              exact_self=exact_self, compute_dtype=cd, **kw))
    f32, narrow = run(None), run(JAX_DTYPES[dtype])
    t = lambda x: None if x is None else torch.as_tensor(x)
    with torch.no_grad():
        port = lambda cd: port_attention.fused_vector_attention(
            *[t(a[key]) for key in named[:-1]], *[t(x) for x in w], k=a["k"],
            compute_dtype=cd, **{key: t(v) for key, v in a.items() if key not in named})
        got, control = port(dtype), port(None).numpy()
    assert got.dtype == torch.float32
    gap = rel(narrow, f32)
    assert gap > 1e-4  # the mode changes the numbers
    assert rel(got.numpy(), narrow) <= bound * gap, (rel(got.numpy(), narrow), gap)
    assert rel(control, narrow) > bound * gap, (rel(control, narrow), gap)


def test_attention_narrow_mode_is_inference_only(rng):
    a, w = _attention_case(rng, "table", False)
    t = lambda x: None if x is None else torch.as_tensor(x)
    args = [t(a[key]) for key in ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a")] + [t(x) for x in w]
    with pytest.raises(RuntimeError, match="inference only"):
        port_attention.fused_vector_attention(*args, k=a["k"], compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        with torch.no_grad():
            port_attention.fused_vector_attention(*args, k=a["k"], compute_dtype=torch.float64)
    with torch.no_grad(), port_attention.attention_dtype(torch.bfloat16):
        ctx = port_attention.fused_vector_attention(*args, k=a["k"])
        plain = port_attention.fused_vector_attention(*args, k=a["k"],
                                                      compute_dtype=torch.bfloat16)
    torch.testing.assert_close(ctx, plain, rtol=0, atol=0)


# ---------------------------------------------------------------- models in bfloat16


def _model_inputs(rng, model_type, B=2, N=32, Q=20):
    b = batches(int(rng.randint(1 << 16)), 1, B=B, N=N, Q=Q)[0]
    pts, inputs = b["space_samples_src"], b["surface_samples_inputs"]
    if model_type == "arbitrary":
        return (pts, inputs[..., 0:3], inputs[..., 3:6], inputs[..., 6:7]), b
    return (pts, inputs), b


def _both_models(model_type, pair, dtype, rng, args):
    """(port model in ``dtype``, JAX model in ``dtype``, JAX f32 model,
    variables): the same random weights on every side."""
    cfg = config(model_type, None, pair)
    variables = randomize(jax_build_model(cfg).init(
        jax.random.PRNGKey(0), *[jnp.asarray(x) for x in args], train=False), rng)
    port = build_model(config(model_type, dtype, pair), device="cpu")
    port.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                         strict=True)
    return port.eval(), jax_build_model(config(model_type, dtype, pair)), \
        jax_build_model(cfg), variables


def _control(port, model_type, pair):
    """The port in float32 with ``port``'s weights."""
    control = build_model(config(model_type, None, pair), device="cpu")
    control.load_state_dict(port.state_dict(), strict=True)
    return control.train(port.training)


# bound: the port-vs-JAX gap over JAX's own narrow-vs-float32 gap (module
# docstring; measured 0.13, 0.75, 0.05, 0, 0, 0.007)
@pytest.mark.parametrize("model_type,pair,dtype,bound", [
    ("forward", "shipped", "bfloat16", 0.25),
    ("backward", "shipped", "bfloat16", 2.0),
    ("arbitrary", "shipped", "bfloat16", 0.25),
    ("arbitrary", "A", "bfloat16", 0.25),
    ("forward", "B", "bfloat16", 0.25),
    ("arbitrary", "shipped", "float16", 0.25),
])
def test_forward_in_compute_dtype_matches_jax(model_type, pair, dtype, bound, rng):
    """Eval-mode forward through the modules: the output in the compute
    dtype, within ``bound`` times JAX's own narrow-vs-float32 gap of JAX's;
    the float32 control fails that limit, or (bound 2) moves nothing."""
    args, _ = _model_inputs(rng, model_type)
    port, jmodel, jf32, variables = _both_models(model_type, pair, dtype, rng, args)
    jargs = [jnp.asarray(x) for x in args]
    ref = np.asarray(jmodel.apply(variables, *jargs, train=False).astype(jnp.float32))
    f32 = np.asarray(jf32.apply(variables, *jargs, train=False))
    with torch.no_grad():
        got = port(*[torch.from_numpy(x) for x in args])
        control = _control(port, model_type, pair)(*[torch.from_numpy(x) for x in args]).numpy()
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    gap = rel(ref, f32)
    assert gap > 0
    assert rel(got, ref) <= bound * gap, (rel(got, ref), gap)
    if bound < 1:
        assert rel(control, ref) > bound * gap, (rel(control, ref), gap)
    moves_as_jax_moves(got, control, ref, f32)


def test_layers_compute_in_the_dtypes_flax_gives(rng):
    """BatchNorm outputs the compute dtype with float32 statistics; the
    fused branch's projections compute float32; the decoder's in the
    compute dtype; parameters and buffers stay float32."""
    model = build_model(config("forward", "bfloat16"), device="cpu")
    enc, dec = model.encoder, model.decoder
    x = torch.randn(2, 8, 16, dtype=torch.bfloat16)
    assert enc.elementwise[0].bn1(x).dtype == torch.bfloat16
    assert enc.elementwise[0].conv1(x).dtype == torch.bfloat16
    assert enc.transformer_downs[1].w_qs(x).dtype == torch.float32
    assert enc.final_transformers[0].w_qs(x).dtype == torch.bfloat16  # group-all
    assert dec.ct1.w_qs(x).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())
    enc_out = model.encode(torch.randn(2, 32, 7))
    assert enc_out["anchor_feats"].dtype == torch.bfloat16
    assert enc_out["anchors"].dtype == torch.float32


# ---------------------------------------------------------------- train steps in bfloat16


def _jax_step(jmodel, variables, batch, arbitrary):
    """JAX's train-step loss, gradients and BatchNorm statistics
    (``nsdp_tpu/training/steps.py::make_steps``'s ``loss_fn``)."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    inputs = b["surface_samples_inputs"]
    args = ((b["space_samples_src"], inputs[..., 0:3], inputs[..., 3:6], inputs[..., 6:7])
            if arbitrary else (b["space_samples_src"], inputs))

    def loss_fn(params):
        pred, mutated = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     *args, train=True, mutable=["batch_stats"])
        return jax_l2(pred, b["space_samples_tgt"]), mutated["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    if arbitrary:
        stats = jax.tree_util.tree_map(lambda x: x, dict(stats))
        cano = dict(stats["model_canonicalize"])
        cano["encoder"] = _double_bn_update(
            cano["encoder"], variables["batch_stats"]["model_canonicalize"]["encoder"])
        stats["model_canonicalize"] = cano
    flat = lambda t: {k: np.asarray(v, np.float32) for k, v in flatten_dict(t).items()}
    return float(loss), flat(grads), flat(stats)


def _port_step(model, model_type, batch):
    """The port's train step (SGD): loss, gradients and BatchNorm
    statistics as flat JAX-keyed dicts."""
    _, opt = optimizer_factory({"optimizer": "SGD", "lr": 1e-3}, model.parameters())
    loss = make_steps(model, model_type, opt, device="cpu")["train_step"](batch, 1e-3)
    grads = {n: p.grad.float().numpy().copy() for n, p in model.named_parameters()}
    params, _ = translate_state_dict(grads)
    _, stats = jax_variables(model)
    return loss, dict(params), {k: np.asarray(v) for k, v in flatten_dict(stats).items()}


def is_gamma_second_bias(path):
    """fc_gamma's second bias: its gradient vanishes analytically (a bias
    shared by every slot cancels in the slot softmax), so both sides hold
    rounding noise there."""
    return "fc_gamma" in "/".join(path) and path[-2:] == ("fc1", "bias")


@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_train_step_in_bfloat16_matches_jax(model_type, rng):
    """One stage-1 / stage-2 train step under ``compute_dtype: bfloat16``
    with ``fused_attention: true``: the loss (float32, from bfloat16
    predictions), every gradient and every updated running statistic
    within twice JAX's own bfloat16-vs-float32 gap of JAX's bfloat16 step,
    with a floor of 1e-6 (float32 rounding) where bfloat16 moves nothing
    (the first block's statistics of a coordinate-only encoder); the
    gradients and parameters stay float32.  fc_gamma's second bias, whose
    gradient is rounding noise on every side (largest ratio measured
    2.03), is held to noise of JAX's own size: its norm at most 4 times
    JAX's.  Taken whole, the loss, the gradients (all leaves as one vector)
    and the statistics are held at 1/4 of the gap (measured 0, 0.05 / 0.03,
    0), which the float32 control fails (1.0, 0.92 / 2.95, 1.0)."""
    arbitrary = model_type == "arbitrary"
    args, batch = _model_inputs(rng, model_type)
    port, jmodel, jf32, variables = _both_models(model_type, "shipped", "bfloat16", rng, args)
    control = _control(port, model_type, "shipped").train()
    loss, grads, stats = _port_step(port.train(), model_type, batch)
    closs, cgrads, cstats = _port_step(control, model_type, batch)
    jloss, jgrads, jstats = _jax_step(jmodel, variables, batch, arbitrary)
    floss, fgrads, fstats = _jax_step(jf32, variables, batch, arbitrary)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port.parameters())
    assert abs(loss - jloss) <= abs(jloss - floss) / 4, (loss, jloss, floss)
    assert abs(closs - jloss) > abs(jloss - floss) / 4, (closs, jloss, floss)
    for what, got, ctl, want, f32 in (("grad", grads, cgrads, jgrads, fgrads),
                                      ("stat", stats, cstats, jstats, fstats)):
        assert sorted(got) == sorted(want), what
        whole = lambda leaves: np.concatenate([np.ravel(leaves[path]) for path in sorted(want)])
        gap = rel(whole(want), whole(f32))
        assert rel(whole(got), whole(want)) <= gap / 4, (what, rel(whole(got), whole(want)), gap)
        assert rel(whole(ctl), whole(want)) > gap / 4, (what, rel(whole(ctl), whole(want)), gap)
        for path in want:
            name = f"{what} {'/'.join(path)}"
            if what == "grad" and is_gamma_second_bias(path):
                assert np.linalg.norm(got[path]) <= 4 * np.linalg.norm(want[path]), name
                continue
            gap = rel(want[path], f32[path])
            assert rel(got[path], want[path]) <= max(2 * gap, 1e-6), (name, gap)


# ---------------------------------------------------------------- remat


def _remat_step(model_type, remat, batch, seed=0):
    """One Adam step of a seeded model -> (loss, model, optimizer)."""
    model = init_random(build_model(config(model_type, remat=remat), device="cpu"), seed)
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, model.parameters())
    loss = make_steps(model, model_type, opt, device="cpu")["train_step"](batch, 1e-3)
    return loss, model, opt


@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_remat_is_bit_for_bit_the_plain_step(model_type):
    """``remat: true`` recomputes each encoder and decoder call in the
    backward: the loss, every gradient, every parameter after the step and
    every BatchNorm buffer (``num_batches_tracked`` included) equal the
    step without it bit for bit, so each running statistic moved once."""
    batch = batches(3, 1, B=2, N=32, Q=20)[0]
    loss, plain, _ = _remat_step(model_type, False, batch)
    rloss, remat, _ = _remat_step(model_type, True, batch)
    assert all(isinstance(m, torch.nn.Module) for m in (plain, remat))
    assert rloss == loss
    for (name, p), (_, q) in zip(plain.named_parameters(), remat.named_parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=0, msg=f"grad {name}")
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    for (name, b), (_, c) in zip(plain.named_buffers(), remat.named_buffers()):
        torch.testing.assert_close(c, b, rtol=0, atol=0, msg=name)
    counts = {int(m.num_batches_tracked) for m in remat.modules() if isinstance(m, BatchNorm)}
    assert counts == {1}


def test_remat_recomputes_in_the_backward_only_in_training():
    """The wrapper runs only in train mode with grad on: each encoder and
    decoder call of a train step starts twice (the recompute; it stops
    early, once the backward has what it needs), an eval or no-grad
    forward once."""
    model = init_random(build_model(config("forward", remat=True), device="cpu"), 0)
    calls = []
    for name in ("encoder", "decoder"):
        getattr(model, name).register_forward_pre_hook(lambda m, i, n=name: calls.append(n))
    batch = batches(4, 1, B=2, N=32, Q=20)[0]
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, model.parameters())
    steps = make_steps(model, "forward", opt, device="cpu")
    steps["train_step"](batch, 1e-3)
    assert sorted(calls) == ["decoder", "decoder", "encoder", "encoder"]
    calls.clear()
    steps["validate_step"](batch)
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(batch["space_samples_src"]),
              torch.from_numpy(batch["surface_samples_inputs"]))
    assert sorted(calls) == ["decoder", "decoder", "encoder", "encoder"]


# ---------------------------------------------------------------- evaluation


def test_service_serves_the_shipped_pair_in_float32_under_bfloat16(rng):
    """The JAX service evaluates the shipped pair through
    ``make_fast_predict`` without a compute dtype, on raw float32
    parameters (``nsdp_tpu/serving.py:87``): a bfloat16 config serves the
    float32 results bit for bit, a deform, an edit session and a drag."""
    state = init_random(build_model(config(), device="cpu"), 5).state_dict()
    pts = rng.randn(50, 3).astype(np.float32)
    inputs = batches(5, 1, B=1, N=32, Q=4)[0]["surface_samples_inputs"][0]
    outs = []
    for dtype in (None, "bfloat16"):
        svc = DeformationService(config(dtype=dtype), state_dict=state, device="cpu",
                                 buckets=(64,))
        assert all(p.dtype == torch.float32 for p in svc.model.parameters())
        session = svc.edit_session(pts, inputs[:, 0:3])
        outs.append((svc.deform(pts, inputs), session.drag(inputs[:, 3:6], inputs[:, 6:7])))
    for a, b in zip(*outs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_service_serves_an_ablation_pair_in_bfloat16(rng):
    """Configuration A evaluates through the modules in the config's
    dtype, as the JAX package's flax path does: within 1/4 of JAX's own
    bfloat16-vs-float32 gap of JAX's bfloat16 forward (measured 0), as
    float32 numpy; a float32 service of the same weights is not (1.02)."""
    args, _ = _model_inputs(rng, "arbitrary", B=1)
    port, jmodel, jf32, variables = _both_models("arbitrary", "A", "bfloat16", rng, args)
    inputs = np.concatenate(args[1:], -1)[0]
    got, control = (DeformationService(config(dtype=dtype, pair="A"), state_dict=port.state_dict(),
                                       device="cpu", buckets=(64,)).deform(args[0][0], inputs)
                    for dtype in ("bfloat16", None))
    jargs = [jnp.asarray(x) for x in args]
    ref = np.asarray(jmodel.apply(variables, *jargs, train=False).astype(jnp.float32))[0]
    f32 = np.asarray(jf32.apply(variables, *jargs, train=False))[0]
    assert got.dtype == np.float32
    assert rel(got, ref) <= rel(ref, f32) / 4, (rel(got, ref), rel(ref, f32))
    assert rel(control, ref) > rel(ref, f32) / 4, (rel(control, ref), rel(ref, f32))


def test_predict_narrow_mode_matches_make_fast_predict(rng):
    """``FlowArbitrary.predict(compute_dtype=torch.bfloat16)`` is
    ``make_fast_predict(compute_dtype=jnp.bfloat16)``: K1's narrow mode at
    every site, every other layer float32; within 1 times JAX's own
    bfloat16-vs-float32 gap (the decoder's cross sites round ``dx``, JAX its
    split delta; measured 0.81), moving the result as far as JAX's mode
    moves it (measured 1.46 times).  Without the keyword, the float32
    forward bit for bit."""
    args, _ = _model_inputs(rng, "arbitrary")
    port, _, jf32, variables = _both_models("arbitrary", "shipped", None, rng, args)
    inputs = np.concatenate(args[1:], -1)
    fast = lambda cd: np.asarray(make_fast_predict(
        jf32, variables, "arbitrary", nneigh=CFG["model"]["decoder_kwargs"]["nneigh"],
        interpret=True, compute_dtype=cd)(jnp.asarray(args[0]), jnp.asarray(inputs)))
    ref, f32 = fast(jnp.bfloat16), fast(None)
    with torch.no_grad():
        t = [torch.from_numpy(x) for x in (args[0], inputs)]
        got, control = port.predict(*t, compute_dtype=torch.bfloat16), port.predict(*t)
        torch.testing.assert_close(control, port(*[torch.from_numpy(x) for x in args]),
                                   rtol=0, atol=0)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), ref) <= rel(ref, f32), (rel(got.numpy(), ref), rel(ref, f32))
    moves_as_jax_moves(got.numpy(), control.numpy(), ref, f32)


def test_remat_recompute_takes_the_forward_batchnorm_group(monkeypatch):
    """Under ``bn_sync`` a recomputed BatchNorm all-reduces its statistics
    again over the forward's group, also when the backward runs on another
    thread (as the autograd engine runs a card's backward): the context
    variable is captured by ``checkpoint_contexts``.  One gloo rank, so the
    results equal the step without remat bit for bit."""
    import threading

    import torch.distributed as dist

    import nsdp_tpu_torch.nn.blocks as blocks
    from tests.torch_parallel_runner import _free_port

    calls = []
    reduce = blocks.all_reduce_sum
    monkeypatch.setattr(blocks, "all_reduce_sum",
                        lambda t, g: calls.append(threading.get_ident()) or reduce(t, g))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        batch = batches(6, 1, B=2, N=32, Q=20)[0]
        grads = {}
        for remat in (False, True):
            model = init_random(build_model(config("forward", remat=remat), device="cpu"), 0)
            model.train()
            calls.clear()
            with blocks.bn_sync(dist.group.WORLD):
                pred = model(torch.from_numpy(batch["space_samples_src"]),
                             torch.from_numpy(batch["surface_samples_inputs"]))
            loss = ((pred - torch.from_numpy(batch["space_samples_tgt"])) ** 2).mean()
            forward_calls = len(calls)
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(timeout=120)
            assert not worker.is_alive()
            in_backward = [t for t in calls[forward_calls:] if t == worker.ident]
            grads[remat] = ([p.grad.clone() for p in model.parameters()], len(in_backward),
                            forward_calls)
        (g0, n0, f0), (g1, n1, f1) = grads[False], grads[True]
        # the remat backward reruns every forward all-reduce of the
        # statistics (the encoder's), on the backward's thread
        assert f0 == f1 > 0 and n0 == 0 and n1 == f0
        for a, b in zip(g0, g1):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


def test_train_entry_point_and_watch_stats_in_bfloat16(tmp_path):
    """``python -m nsdp_tpu_torch.train --device cpu`` on a ``compute_dtype:
    bfloat16`` config trains and writes float32 model files; ``watch_stats``
    under it gives finite norms and leaves the model as it was."""
    import yaml

    import nsdp_tpu_torch.train as port_train
    from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config
    from nsdp_tpu_torch.training import read_state_dict

    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=2, n_frames=4,
                                    n_surface=200, n_space=200)
    cfg = synthetic_config(fx)
    cfg["model"]["compute_dtype"] = "bfloat16"
    cfg["experiment"]["out_dir"] = str(tmp_path / "out")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    port_train.main([str(path), "--device", "cpu", "--seed", "0"])
    out = tmp_path / "out" / cfg["experiment"]["name"]
    files = sorted(p.name for p in out.iterdir())
    assert "model_00000" in files and "stats.txt" in files
    state = read_state_dict(str(out / "model_00000"))
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.values())
    assert all(torch.isfinite(v).all() for v in state.values() if v.is_floating_point())

    model = build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, model.parameters())
    steps = make_steps(model, cfg["model"]["type"], opt, device="cpu")
    (ptop, pleaves), (gtop, gleaves) = steps["watch_stats"](batches(7, 1, B=2, N=200, Q=50)[0])
    assert np.isfinite(pleaves).all() and np.isfinite(gleaves).all() and gleaves.max() > 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
