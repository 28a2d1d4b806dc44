"""Captured programs (``nsdp_tpu_torch.graphs``) in serving and training.

On the CPU a program keeps the captured path's static-buffer contract
(its outputs are overwritten by the next call of any program of its
``Graphs``) and runs the function directly, so these tests show that the
serving, training and evaluation paths keep nothing a later call
overwrites, and that the captured-contract steps (with a gloo group too)
are the eager steps bit for bit.  The ``gpu`` tests hold the captured
programs against the eager path on the card, at a small size: serving,
the train step, the evaluation programs, a gloo group's rule and one NCCL
rank; and, at the published widths, the kernels each replay launches (its
graph's kernel nodes) against one evaluation's or one step's.  The module
imports nothing of JAX, so it also runs on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs.py
"""

import contextlib
import copy
import os
import re
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from nsdp_tpu_torch import graphs as port_graphs
from nsdp_tpu_torch.graphs import Graphs
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops import fps as port_fps
from nsdp_tpu_torch.ops import gather as port_gather
from nsdp_tpu_torch.ops import knn as port_knn
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.training import make_steps, optimizer_factory
from nsdp_tpu_torch.utils.config import load_config
from tests.torch_parallel_runner import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENC_KW = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nneighbor_reduced=4,
              nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True)
DEC_KW = dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3)
PNPP_KW = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nfinal_transformers=1,
               d_transformer=16)


def shipped_config(name):
    """A shipped ``configs/deform4d/<name>.yaml`` at its published widths,
    or an ablation built from one as the JAX package's tests build theirs:
    A, ``arbitrary.yaml`` with the ``pointnet++`` encoder; B,
    ``forward.yaml`` with that encoder and the ``interp`` decoder."""
    cfg = load_config(os.path.join(REPO, "configs", "deform4d",
                                   {"A": "arbitrary", "B": "forward"}.get(name, name) + ".yaml"))
    if name in ("A", "B"):
        model = cfg["model"]
        model["encoder"] = "pointnet++"
        for key in ("nneighbor_reduced", "d_reduced", "full_SA"):
            model["encoder_kwargs"].pop(key)
        if name == "B":
            model["decoder"] = "interp"
            model["decoder_kwargs"].pop("nneigh")
    return cfg


def config(model_type="arbitrary", encoder="pointransformer", **model):
    return {"model": {"type": model_type, "use_normals": False, "encoder": encoder,
                      "encoder_kwargs": ENC_KW if encoder == "pointransformer" else PNPP_KW,
                      "decoder": "crossatten", "decoder_kwargs": DEC_KW, **model},
            "training": {"optimizer": "Adam", "lr": 1e-3}}


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _request(rng, n=32, q=50):
    surf = rng.randn(n, 3).astype(np.float32)
    handle = (rng.rand(n, 1) > 0.5).astype(np.float32)
    tgt = rng.randn(n, 3).astype(np.float32) * handle
    return rng.randn(q, 3).astype(np.float32), surf, tgt, handle


def _services(cfg, device, buckets=(64,)):
    """(captured, eager) services on ``device`` with the same seeded weights."""
    captured = DeformationService(cfg, buckets=buckets, device=device, graphs=True)
    eager = DeformationService(cfg, state_dict=captured.model.state_dict(), buckets=buckets,
                               device=device, graphs=False)
    return captured, eager


def train_batch(rng, B=2, N=32, Q=12, masked=False):
    """Source and target surfaces with a handle mask, space samples and
    their targets (``__graft_entry__._example_batch``'s layout), drawn from
    ``rng``; ``masked`` pads each item's last 5 surface rows
    (``surface_valid_mask``)."""
    src, tgt = rng.randn(2, B, N, 3).astype(np.float32)
    handle = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    batch = {"surface_samples_inputs": np.concatenate([src, tgt * handle, handle], -1),
             "space_samples_src": rng.randn(B, Q, 3).astype(np.float32),
             "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32)}
    if masked:
        valid = np.ones((B, N), np.float32)
        valid[:, -5:] = 0.0
        batch["surface_samples_inputs"] *= valid[..., None]
        batch["surface_valid_mask"] = valid
    return batch


def _batches(seed, n, **kw):
    rng = np.random.RandomState(seed)
    return [train_batch(rng, **kw) for _ in range(n)]


def _trainer(cfg, device, graphs, nan_guard=False):
    model = init_random(build_model(cfg, device=device), 0)
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, model.parameters())
    return model, opt, make_steps(model, cfg["model"]["type"], opt, device=device,
                                  nan_guard=nan_guard, graphs=graphs)


def _state(model, opt):
    """Everything a step changes: parameters, every BatchNorm buffer, every
    ``.grad``, the optimizer's state."""
    return ([t.detach().clone() for t in model.state_dict().values()],
            [None if p.grad is None else p.grad.clone() for p in model.parameters()],
            copy.deepcopy(opt.state_dict()["state"]))


def _assert_same_state(a, b):
    for x, y in zip(a[0], b[0]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(a[1], b[1]):  # None after a non-finite step
        assert (x is None) == (y is None)
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        for name in a[2][k]:
            torch.testing.assert_close(a[2][k][name], b[2][k][name], rtol=0, atol=0)


# ---------------------------------------------------------------- the helper


def test_program_keeps_static_buffers_and_one_entry_per_signature():
    graphs = Graphs("cpu")
    fn = lambda x, y: (x + 1.0, [x * 2.0, None])
    x = torch.arange(3.0)
    a = graphs("f", fn, x, None)
    b = graphs("f", fn, x + 10.0, None)
    assert a[0] is b[0] and a[1][0] is b[1][0] and a[1][1] is None
    torch.testing.assert_close(a[0], x + 11.0)  # the first call's output, overwritten
    graphs("f", fn, torch.zeros(4), None)  # a new shape
    graphs("f", fn, x, x)  # an argument no longer None
    graphs("f", fn, x.double(), None)  # a new dtype
    graphs("g", fn, x, None)  # another name
    assert len(graphs.programs) == 5
    assert graphs.programs[("f", (((3,), torch.float32), None))].calls == 2
    with pytest.raises(TypeError):
        graphs("f", fn, np.zeros(3), None)


def test_copy_gives_outputs_the_caller_owns():
    """``copy=True`` returns a copy of the static outputs: the next call
    overwrites the static outputs and leaves the copy."""
    graphs = Graphs("cpu")
    fn = lambda x: (x + 1.0, [x * 2.0, None])
    x = torch.arange(3.0)
    held = graphs("f", fn, x, copy=True)
    static = graphs("f", fn, x + 10.0)
    assert held[0] is not static[0] and held[1][0] is not static[1][0] and held[1][1] is None
    torch.testing.assert_close(held[0], x + 1.0)
    torch.testing.assert_close(held[1][0], x * 2.0)
    graphs("f", fn, x + 20.0)
    torch.testing.assert_close(static[0], x + 21.0)  # the static output, overwritten


# ---------------------------------------------------------------- serving


def test_captured_contract_serving_equals_eager(rng):
    captured, eager = _services(config(), "cpu")
    pts, surf, tgt, handle = _request(rng)
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    for args in ((pts, inputs, None), (pts, inputs * pm[:, None], pm)):
        np.testing.assert_array_equal(captured.deform(*args), eager.deform(*args))
    for point_mask in (None, pm):
        session, eager_session = (s.edit_session(pts, surf, point_mask) for s in (captured, eager))
        for scale in (1.0, 0.5):
            np.testing.assert_array_equal(session.drag(tgt * scale, handle),
                                          eager_session.drag(tgt * scale, handle))


def test_second_session_leaves_the_first_sessions_drags(rng):
    """Two edit sessions at one bucket, their drags interleaved: each drags
    its own canonical pose (the canonicalisation program's outputs are
    overwritten by the second session)."""
    captured, eager = _services(config(), "cpu")
    pts, surf, tgt, handle = _request(rng)
    pts2, surf2, _, _ = _request(rng)
    first = captured.edit_session(pts, surf)
    before = first.drag(tgt, handle)
    second = captured.edit_session(pts2, surf2)
    dragged2 = second.drag(tgt, handle)
    np.testing.assert_array_equal(first.drag(tgt, handle), before)
    np.testing.assert_array_equal(before, eager.edit_session(pts, surf).drag(tgt, handle))
    np.testing.assert_array_equal(dragged2, eager.edit_session(pts2, surf2).drag(tgt, handle))
    assert not np.array_equal(before, dragged2)


def test_replicas_capture_their_own_programs(rng):
    """``devices=`` under the captured contract: each replica keeps its own
    programs; the service equals the same replicas eager bit for bit and
    the one-device service within the query split's tolerance, and an
    interleaved second session leaves the first session's drags."""
    cfg = config()
    two = DeformationService(cfg, devices=("cpu", "cpu"), buckets=(64,), graphs=True)
    weights = two.model.state_dict()
    eager = DeformationService(cfg, devices=("cpu", "cpu"), state_dict=weights, buckets=(64,),
                               graphs=False)
    one = DeformationService(cfg, device="cpu", state_dict=weights, buckets=(64,), graphs=False)
    tol = dict(rtol=1e-5, atol=1e-6)  # the same rows through products of fewer rows
    pts, surf, tgt, handle = _request(rng)
    pts2, surf2, _, _ = _request(rng)
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    for args in ((pts, inputs, None), (pts, inputs * pm[:, None], pm)):
        got = two.deform(*args)
        np.testing.assert_array_equal(got, eager.deform(*args))
        np.testing.assert_allclose(got, one.deform(*args), **tol)
    first = two.edit_session(pts, surf)
    before = first.drag(tgt, handle)
    second = two.edit_session(pts2, surf2)
    np.testing.assert_array_equal(second.drag(tgt * 0.5, handle),
                                  eager.edit_session(pts2, surf2).drag(tgt * 0.5, handle))
    np.testing.assert_array_equal(first.drag(tgt, handle), before)
    np.testing.assert_array_equal(before, eager.edit_session(pts, surf).drag(tgt, handle))
    np.testing.assert_allclose(before, one.edit_session(pts, surf).drag(tgt, handle), **tol)
    assert two.graphs[0] is not two.graphs[1]
    names = [sorted(name for name, _ in g.programs) for g in two.graphs]
    assert names[0] == names[1] == ["canonicalize", "deform", "deform", "drag"]


def test_warmup_captures_each_entry_once_per_bucket_n_and_mask(rng):
    svc = DeformationService(config(), buckets=(64, 128), device="cpu", graphs=True)
    svc.warmup(32)
    programs = svc.graphs[0].programs
    by_name = {}
    for name, sig in programs:
        by_name.setdefault(name, []).append(sig)
    # 2 buckets x (no mask, mask) for each entry
    assert {k: len(v) for k, v in by_name.items()} == {"deform": 4, "canonicalize": 4, "drag": 4}
    pts, surf, tgt, handle = _request(rng, q=100)
    inputs = np.concatenate([surf, tgt, handle], -1)
    svc.deform(pts, inputs)  # bucket 128, 32 points, no mask: reused
    svc.deform(pts[:40], inputs)  # bucket 64: reused
    assert len(programs) == 12
    assert programs[("deform", (((1, 128, 3), torch.float32), ((1, 32, 7), torch.float32),
                                None))].calls == 2
    svc.deform(pts, np.concatenate([inputs, inputs]))  # 64 conditioning points: new
    assert len(programs) == 13


# ---------------------------------------------------------------- training


STEP_CASES = {
    "stage1": (config("forward"), {}, {}),
    "stage2": (config("arbitrary"), {}, {}),
    "stage2_masked": (config("arbitrary"), {}, {"masked": True}),
    "stage1_remat": (config("forward", remat=True), {}, {}),
    "stage2_bf16": (config("arbitrary", compute_dtype="bfloat16"), {}, {}),
    "stage1_pointnet": (config("forward", encoder="pointnet++"), {}, {}),
    "stage2_nan_guard": (config("arbitrary"), {"nan_guard": True}, {}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_captured_contract_step_equals_eager_step(case):
    """Four steps (the first the eager warm-up, the second the capture):
    every loss, and after each step the parameters, BatchNorm buffers,
    gradients and optimizer state, bit for bit the eager step's.  Under
    ``nan_guard`` the third batch's target holds a NaN."""
    cfg, kw, batch_kw = STEP_CASES[case]
    runs = [_trainer(cfg, "cpu", graphs, **kw) for graphs in (True, False)]
    assert runs[0][2]["train_step"].graphs is not None and runs[1][2]["train_step"].graphs is None
    batches = _batches(1, 4, **batch_kw)
    if kw.get("nan_guard"):
        batches[2]["space_samples_tgt"][0, 0, 0] = np.nan
    for i, batch in enumerate(batches):
        losses = [steps["train_step"](batch, 1e-3) for _, _, steps in runs]
        assert np.isnan(losses[0]) if i == 2 and kw else np.isfinite(losses[0])
        np.testing.assert_array_equal(losses[0], losses[1])
        _assert_same_state(*(_state(model, opt) for model, opt, _ in runs))
    (program,) = runs[0][2]["train_step"].graphs.programs.values()
    assert program.calls == 4


def test_learning_rate_change_between_captured_steps():
    runs = [_trainer(config("arbitrary"), "cpu", graphs) for graphs in (True, False)]
    for batch, lr in zip(_batches(2, 3), (1e-3, 1e-3, 2.5e-4)):
        losses = [steps["train_step"](batch, lr) for _, _, steps in runs]
        assert losses[0] == losses[1]
    _assert_same_state(*(_state(model, opt) for model, opt, _ in runs))
    assert runs[0][1].param_groups[0]["lr"] == 2.5e-4


def test_unfetched_loss_is_the_callers():
    """``train_step(..., fetch=False)`` returns a loss the next step does
    not overwrite (``train``'s loss is read one step late)."""
    _, _, captured = _trainer(config("forward"), "cpu", True)
    _, _, eager = _trainer(config("forward"), "cpu", False)
    batches = _batches(3, 3)
    held = [captured["train_step"](b, 1e-3, fetch=False) for b in batches]
    want = [eager["train_step"](b, 1e-3) for b in batches]
    assert [float(x) for x in held] == want and len(set(want)) == 3


@contextlib.contextmanager
def _group(backend, device=None):
    """A one-rank process group of ``backend`` on a free local port."""
    if device is not None:
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("graphs", [True, None])
def test_grouped_steps_under_gloo_on_the_cpu(graphs):
    """A gloo group on the CPU: ``graphs=True`` keeps the captured
    contract for every step (the tests hold it), ``graphs=None`` stays
    eager; either way the steps equal the eager steps without a group."""
    with _group("gloo") as group:
        model, opt, steps = _trainer(config("arbitrary"), "cpu", None)
        twin = init_random(build_model(config("arbitrary"), device="cpu"), 0)
        _, twin_opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, twin.parameters())
        grouped = make_steps(twin, "arbitrary", twin_opt, device="cpu", group=group,
                             graphs=graphs)
        assert steps["train_step"].graphs is None
        for name in ("train_step", "validate_step", "watch_stats", "predict"):
            assert (grouped[name].graphs is not None) == bool(graphs), name
        for batch in _batches(4, 3):
            assert grouped["train_step"](batch, 1e-3) == steps["train_step"](batch, 1e-3)
        _assert_same_state(_state(twin, twin_opt), _state(model, opt))
        _assert_same_evaluation(grouped, steps, _batches(8, 2, masked=True))
    if graphs:
        (program,) = [p for (name, _), p in grouped["train_step"].graphs.programs.items()
                      if name == "train_step"]
        assert program.calls == 3


def _evaluate(steps, batch, other):
    """Every evaluation step on ``batch`` (``other``: a batch of the same
    signature, called in between) -> host copies of their outputs; the
    first ``predict`` output is held across the second call."""
    sample_mask = np.array([1.0, 0.0], np.float32)
    held = steps["predict"](batch["space_samples_src"], batch["surface_samples_inputs"],
                            batch.get("surface_valid_mask"))
    steps["predict"](other["space_samples_src"], other["surface_samples_inputs"],
                     other.get("surface_valid_mask"))
    (p_top, p_leaves), (g_top, g_leaves) = steps["watch_stats"](batch)
    return dict(validate=steps["validate_step"](batch),
                masked=steps["validate_step_masked"](batch, sample_mask),
                predict=held.clone(), watch=(p_top, p_leaves, g_top, g_leaves))


def _assert_same_evaluation(steps, eager, batches):
    for batch, other in zip(batches, batches[1:] + batches[:1]):
        for _ in range(2):  # the capture and a replay at each signature
            got, want = _evaluate(steps, batch, other), _evaluate(eager, batch, other)
            assert got["validate"] == want["validate"] and got["masked"] == want["masked"]
            torch.testing.assert_close(got["predict"], want["predict"], rtol=0, atol=0)
            for a, b in zip(got["watch"], want["watch"]):
                if isinstance(a, dict):
                    assert a == b
                else:
                    np.testing.assert_array_equal(a, b)


EVAL_CASES = ["stage1", "stage2", "stage2_masked", "stage1_pointnet", "stage2_bf16"]


@pytest.mark.parametrize("case", EVAL_CASES)
def test_captured_contract_evaluation_equals_eager(case):
    """``validate_step``, ``validate_step_masked``, ``watch_stats`` and
    ``predict`` on the captured contract, bit for bit the eager ones at
    each call, after two train steps (so ``.grad`` and Adam's moments
    exist): a ``predict`` output held across the next call keeps its
    values, and ``watch_stats`` leaves the parameters, every buffer,
    ``.grad``, the optimizer and the train/eval mode as they were."""
    cfg, _, batch_kw = STEP_CASES[case]
    runs = [_trainer(cfg, "cpu", graphs) for graphs in (True, False)]
    for batch in _batches(11, 2, **batch_kw):
        for _, _, steps in runs:
            steps["train_step"](batch, 1e-3)
    evaluation = runs[0][2]["predict"].graphs
    assert evaluation is not None and evaluation is runs[0][2]["train_step"].graphs
    assert all(runs[0][2][k].graphs is evaluation
               for k in ("validate_step", "validate_step_masked", "watch_stats"))
    model, opt, steps = runs[0]
    for training in (True, False):
        model.train(training)
        before = _state(model, opt)
        steps["watch_stats"](_batches(12, 1, **batch_kw)[0])
        assert model.training == training
        _assert_same_state(before, _state(model, opt))
    _assert_same_evaluation(steps, runs[1][2], _batches(13, 2, **batch_kw))
    names = sorted({name for name, _ in evaluation.programs})
    assert names == ["predict", "train_step", "validate_step", "validate_step_masked",
                     "watch_stats"]


def test_evaluation_replays_leave_the_train_steps_outputs():
    """One pool for every step: between captured train steps, every
    evaluation step (its capture and replays) leaves ``.grad`` bit for bit
    as the step left it, and a ``nan_guard`` skip after them restores the
    BatchNorm buffers the step snapshotted: the whole run bit for bit the
    eager run's."""
    cfg = config("arbitrary")
    runs = [_trainer(cfg, "cpu", graphs, nan_guard=True) for graphs in (True, False)]
    batches = _batches(14, 5, masked=True)
    batches[3]["space_samples_tgt"][1, 2, 0] = np.nan
    for i, batch in enumerate(batches):
        losses = [steps["train_step"](batch, 1e-3) for _, _, steps in runs]
        np.testing.assert_array_equal(*losses)
        assert np.isnan(losses[0]) == (i == 3)
        after = [_state(model, opt) for model, opt, _ in runs]
        for (model, opt, steps), state in zip(runs, after):
            _evaluate(steps, batches[(i + 1) % 5], batches[(i + 2) % 5])
            _assert_same_state(state, _state(model, opt))
        _assert_same_state(*after)
    assert runs[0][2]["train_step"].graphs is runs[0][2]["validate_step"].graphs


def _stats_losses(path):
    return re.findall(r"loss: (\S+)", path.read_text())


def test_train_entry_point_under_the_captured_contract(tmp_path, monkeypatch):
    """``python -m nsdp_tpu_torch.train`` with its step on the captured
    contract prints the eager run's losses -- the loss read one step late
    is that step's, not the next one's -- and writes the same model."""
    import nsdp_tpu_torch.train as port_train
    from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config
    from nsdp_tpu_torch.training import read_state_dict

    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=2, n_frames=4,
                                    n_surface=200, n_space=200)
    real = port_train.make_steps
    out = {}
    for graphs in (True, False):
        cfg = synthetic_config(fx)
        cfg["experiment"]["out_dir"] = str(tmp_path / f"out_{graphs}")
        path = tmp_path / f"cfg_{graphs}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        monkeypatch.setattr(port_train, "make_steps",
                            lambda *a, g=graphs, **k: real(*a, graphs=g, **k))
        port_train.main([str(path), "--device", "cpu", "--seed", "0", "--num_workers", "0"])
        out[graphs] = tmp_path / f"out_{graphs}" / cfg["experiment"]["name"]
    losses = [_stats_losses(out[g] / "stats.txt") for g in (True, False)]
    assert losses[0] == losses[1] and len(set(losses[0])) > 2
    for name in ("model_00000", "model_00001"):
        a, b = (read_state_dict(str(out[g] / name)) for g in (True, False))
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["pointransformer", "pointnet++"])
def test_captured_serving_equals_eager_on_the_card(cuda, rng, encoder):
    captured, eager = _services(config(encoder=encoder), cuda, buckets=(64, 128))
    captured.warmup(32)
    pts, surf, tgt, handle = _request(rng, q=100)
    pts2, surf2, _, _ = _request(rng, q=100)
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    for q in (40, 100):
        for args in ((pts[:q], inputs, None), (pts[:q], inputs * pm[:, None], pm)):
            np.testing.assert_array_equal(captured.deform(*args), eager.deform(*args))
    first, first_eager = captured.edit_session(pts, surf), eager.edit_session(pts, surf)
    before = first.drag(tgt, handle)
    np.testing.assert_array_equal(before, first_eager.drag(tgt, handle))
    second = captured.edit_session(pts2, surf2)
    np.testing.assert_array_equal(second.drag(tgt * 0.5, handle),
                                  eager.edit_session(pts2, surf2).drag(tgt * 0.5, handle))
    np.testing.assert_array_equal(first.drag(tgt, handle), before)
    assert all(p.graph is not None for p in captured.graphs[0].programs.values())


@pytest.mark.gpu
def test_captured_replicas_equal_eager_on_the_card(cuda, rng):
    """Two replicas on one card, each capturing its own programs, against
    the same replicas eager, bit for bit; interleaved sessions."""
    devices = (f"cuda:{cuda.index or 0}",) * 2
    cfg = config()
    cap = DeformationService(cfg, devices=devices, buckets=(64, 128))
    assert cap.graphs is not None
    eager = DeformationService(cfg, devices=devices, state_dict=cap.model.state_dict(),
                               buckets=(64, 128), graphs=False)
    cap.warmup(32)
    pts, surf, tgt, handle = _request(rng, q=100)
    pts2, surf2, _, _ = _request(rng, q=100)
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    for q in (40, 100):
        for args in ((pts[:q], inputs, None), (pts[:q], inputs * pm[:, None], pm)):
            np.testing.assert_array_equal(cap.deform(*args), eager.deform(*args))
    first = cap.edit_session(pts, surf)
    before = first.drag(tgt, handle)
    np.testing.assert_array_equal(before, eager.edit_session(pts, surf).drag(tgt, handle))
    second = cap.edit_session(pts2, surf2)
    np.testing.assert_array_equal(second.drag(tgt * 0.5, handle),
                                  eager.edit_session(pts2, surf2).drag(tgt * 0.5, handle))
    np.testing.assert_array_equal(first.drag(tgt, handle), before)
    assert all(p.graph is not None for g in cap.graphs for p in g.programs.values())


def rel_err(a, ref) -> float:
    """Relative L2 error ``||a - ref|| / ||ref||``, in float64."""
    a, ref = a.double(), ref.double()
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))


def _hold_step(runs):
    """Three steps from one state, each (loss, model, optimizer): a
    replayed one, an eager one and a second eager one.  The first two's
    loss and every buffer bit for bit; each parameter, buffer and gradient
    bit for bit or, where K2's float64 atomics reorder, its relative gap to
    the eager step's at most 4 times the two eager steps' own (floor
    1e-4)."""
    (loss, model, _), (loss_e, eager, _), _ = runs
    assert loss == loss_e
    for a, b in zip(model.buffers(), eager.buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    (c, cg, _), (e, eg, _), (e2, eg2, _) = (_state(m, o) for _, m, o in runs)
    for i, (got, want, again) in enumerate([*zip(c, e, e2), *zip(cg, eg, eg2)]):
        assert (got is None) == (want is None), i
        if got is not None and not torch.equal(got, want):
            assert rel_err(got, want) <= max(4 * rel_err(again, want), 1e-4), i


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_captured_step_equals_eager_on_the_card(cuda, model_type):
    """From one state, a replayed step against two eager ones: the loss
    and every buffer bit for bit; each gradient and parameter bit for bit
    or, where K2's float64 atomics reorder, within 4 times the two eager
    steps' own relative gap (floor 1e-4)."""
    cfg = config(model_type)
    model, opt, steps = _trainer(cfg, cuda, True)
    twins = [_trainer(cfg, cuda, False) for _ in range(2)]
    batches = _batches(5, 3)
    steps["train_step"](batches[0], 1e-3)  # the eager warm-up
    steps["train_step"](batches[1], 1e-3)  # the capture, replayed once
    for m, o, _ in twins:
        m.load_state_dict(model.state_dict())
        o.load_state_dict(copy.deepcopy(opt.state_dict()))
    _hold_step([(s["train_step"](batches[2], 1e-3), m, o)
                for m, o, s in [(model, opt, steps), *twins]])


def _assert_evaluation_on_the_card(steps, eager, batches):
    """:func:`_assert_same_evaluation` on the card: every output bit for
    bit, but the gradient norms of ``watch_stats``, whose K2 sums in
    float64 atomics in no fixed order (relative 1e-5)."""
    for batch, other in zip(batches, batches[1:] + batches[:1]):
        for _ in range(2):
            got, want = _evaluate(steps, batch, other), _evaluate(eager, batch, other)
            assert got["validate"] == want["validate"] and got["masked"] == want["masked"]
            torch.testing.assert_close(got["predict"], want["predict"], rtol=0, atol=0)
            (p_top, p_leaves, g_top, g_leaves), (wp_top, wp_leaves, wg_top, wg_leaves) = (
                got["watch"], want["watch"])
            assert p_top == wp_top
            np.testing.assert_array_equal(p_leaves, wp_leaves)
            np.testing.assert_allclose(g_leaves, wg_leaves, rtol=1e-5, atol=0)
            np.testing.assert_allclose([g_top[k] for k in wg_top], list(wg_top.values()),
                                       rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_captured_evaluation_equals_eager_on_the_card(cuda, model_type):
    """The evaluation programs against the eager steps with the same
    weights; then, after captured train steps (``nan_guard``) in the same
    pool, captured after them, so that the step's outputs may lie in what
    their captures freed, their replays leave ``.grad`` and every buffer
    bit for bit, and a NaN step restores the buffers it snapshotted."""
    cfg = config(model_type)
    model, opt, steps = _trainer(cfg, cuda, None, nan_guard=True)
    _, _, eager = _trainer(cfg, cuda, False, nan_guard=True)
    assert steps["predict"].graphs is not None
    _assert_evaluation_on_the_card(steps, eager, _batches(21, 2, masked=True))
    assert all(p.graph is not None for (name, _), p in steps["predict"].graphs.programs.items()
               if name != "predict")
    batches = _batches(22, 4)
    batches[3]["space_samples_tgt"][0, 0, 0] = np.nan
    for batch in batches[:3]:
        steps["train_step"](batch, 1e-3)
    (program,) = [p for (name, _), p in steps["train_step"].graphs.programs.items()
                  if name == "train_step"]
    assert program.graph is not None and program.calls == 3
    before = _state(model, opt)
    _evaluate(steps, batches[0], batches[1])
    _evaluate(steps, batches[1], batches[0])
    _assert_same_state(before, _state(model, opt))
    assert np.isnan(steps["train_step"](batches[3], 1e-3))
    for a, b in zip(before[0], _state(model, opt)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
def test_eager_calls_hold_no_buffers_on_the_card(cuda):
    """A signature's ``eager_calls`` return the function's own results on
    arguments moved to the card (from the host too), copy nothing and
    hold no static buffer; the next call captures, and ``copy=True``
    copies only a replay's outputs."""
    graphs, made = Graphs(cuda), []
    fn = lambda x: made.append(x * 2.0) or made[-1]
    x = torch.arange(6.0).reshape(2, 3)
    out = graphs("f", fn, x, eager_calls=1, copy=True)
    (program,) = graphs.programs.values()
    assert out is made[-1] and out.device.type == "cuda"
    assert program.inputs is None and program.graph is None and program.outputs is None
    assert graphs.summary() == {"captured": 0, "eager": 1, "replays": 0}
    again = graphs("f", fn, x.to(cuda) + 1.0, eager_calls=1, copy=True)
    assert program.graph is not None and again is not program.outputs
    torch.testing.assert_close(again, (x.to(cuda) + 1.0) * 2.0, rtol=0, atol=0)
    assert graphs.summary() == {"captured": 1, "eager": 0, "replays": 1}


@pytest.mark.gpu
def test_gloo_group_stays_eager_on_the_card(cuda):
    with _group("gloo") as group:
        model = init_random(build_model(config("forward"), device=cuda), 0)
        _, opt = optimizer_factory({"lr": 1e-3}, model.parameters())
        with pytest.raises(ValueError, match="gloo"):
            make_steps(model, "forward", opt, device=cuda, group=group, graphs=True)
        steps = make_steps(model, "forward", opt, device=cuda, group=group)
        assert all(steps[k].graphs is None
                   for k in ("train_step", "validate_step", "watch_stats", "predict"))
        assert np.isfinite(steps["train_step"](_batches(4, 1)[0], 1e-3))


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_nccl_rank_captured_equals_eager_on_the_card(cuda, model_type):
    """One NCCL rank: the grouped step captured by default, its all-reduces
    inside the graph.  From one state a replayed step against the eager
    grouped step and a second eager one (the rule of
    :func:`test_captured_step_equals_eager_on_the_card`); the evaluation
    programs under the group against the eager ones."""
    cfg = config(model_type)
    with _group("nccl", cuda) as group:
        def grouped(graphs):
            model = init_random(build_model(cfg, device=cuda), 0)
            _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, model.parameters())
            return model, opt, make_steps(model, model_type, opt, device=cuda, group=group,
                                          graphs=graphs)

        model, opt, steps = grouped(None)
        twins = [grouped(False) for _ in range(2)]
        assert steps["train_step"].graphs is not None
        batches = _batches(23, 3)
        steps["train_step"](batches[0], 1e-3)
        steps["train_step"](batches[1], 1e-3)
        for m, o, _ in twins:
            m.load_state_dict(model.state_dict())
            o.load_state_dict(copy.deepcopy(opt.state_dict()))
        _hold_step([(s["train_step"](batches[2], 1e-3), m, o)
                    for m, o, s in [(model, opt, steps), *twins]])
        twins[0][0].load_state_dict(model.state_dict())
        _assert_evaluation_on_the_card(steps, twins[0][2], _batches(24, 2, masked=True))


# ------------------------------------------------- the kernels of a replay

# the kernel that marks one launch of each wrapper among a graph's kernel
# nodes: K1 (its selection, in every mode), K2 (its row kernel), K3 (any
# variant), K4, the row gather
LAUNCH_KERNELS = (("knn_kernel",), ("bwd_rows_kernel",),
                  ("fps_kernel", "fps_cluster_kernel", "fps_global_kernel"),
                  ("knn_split_kernel",), ("gather_rows_kernel",))
# (K1, K2, K3, K4, gather) launches of a full evaluation, an edit session
# and a drag: the shipped model, and A's two pointnet++ encoders (FPS, K4
# and the gather at each of 2 levels) and three crossatten decodes
SERVE_LAUNCHES = {
    "arbitrary": {"deform": (17, 0, 4, 0, 0), "session": (9, 0, 2, 0, 0), "drag": (8, 0, 2, 0, 0)},
    "A": {"deform": (3, 0, 4, 4, 4), "session": (2, 0, 2, 2, 2), "drag": (1, 0, 2, 2, 2)},
}
# of a train step: a shipped net runs its begin block, 2 set abstraction
# rounds x 2 levels, 2 transformer_downs and its decoder
STEP_LAUNCHES = {"forward": (8, 8, 2, 0, 0), "backward": (8, 8, 2, 0, 0),
                 "arbitrary": (17, 17, 4, 0, 0), "A": (3, 3, 4, 4, 4), "B": (0, 0, 2, 2, 2)}


def launch_counters():
    """Launches so far of (K1, K2, K3, K4, the row gather), by the wrappers."""
    return (port_attention.fused_vector_attention.launches,
            port_attention.fused_vector_attention_backward.launches,
            port_fps.furthest_point_sample.launches, port_knn.knn.launches,
            port_gather.gather_rows.launches)


def launched_since(before):
    """(K1, K2, K3, K4, gather) launches by the wrappers since ``before``."""
    return tuple(a - b for a, b in zip(launch_counters(), before))


def short_name(mangled: str) -> str:
    """``attn_bcast_kernel<0, 8, 2>`` from a mangled kernel name: its
    length-prefixed names read in turn up to the one ending in
    ``_kernel``, then that name's integer template arguments; the name as
    given where none ends so."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    while True:
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            return mangled
        i += m.end()
        name, i = mangled[i:i + int(m.group())], i + int(m.group())
        if name.endswith("_kernel"):
            args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
            return name + (f"<{', '.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"
                           if args else "")


def graph_launches(program, directory):
    """(K1, K2, K3, K4, gather) launches of one replay of a captured
    program: its graph's kernel nodes, read from the Graphviz dump of the
    node list that ``graphs.KEEP_GRAPHS`` keeps."""
    path = os.path.join(directory, "graph.dot")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch announces each dump
        program.graph.debug_dump(path)
    with open(path) as f:
        nodes = re.split(r'^\s*"graph_\d+_node_\d+"\s*\[', f.read(), flags=re.M)[1:]
    names = [short_name(m.group()).split("<")[0] for m in
             (re.search(r"_Z\w+", node) for node in nodes if "KERNEL" in node) if m]
    assert names, "no kernel node in the dump of a captured graph"
    return tuple(sum(n in kinds for n in names) for kinds in LAUNCH_KERNELS)


def replayed(graphs_list, fn, directory):
    """-> (``fn()``, the launches of the replays it made): the kernel
    nodes of each program of ``graphs_list`` whose calls moved, once a
    call.  The wrappers run at no replay; a call that made a program, or
    that ran one eagerly or captured it, fails."""
    before = [(p, p.calls, p.graph is not None) for g in graphs_list for p in g.programs.values()]
    counters = launch_counters()
    out = fn()
    assert launch_counters() == counters
    assert len(before) == sum(len(g.programs) for g in graphs_list)
    launches = np.zeros(5, int)
    for p, calls, captured in before:
        if p.calls != calls:
            assert captured, "a call expected to replay ran eagerly or captured"
            launches += (p.calls - calls) * np.array(graph_launches(p, directory))
    return out, tuple(int(x) for x in launches)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SERVE_LAUNCHES))
def test_serving_replays_launch_one_evaluation_on_the_card(cuda, name, monkeypatch, tmp_path):
    """The shipped model and ablation A served at their published widths
on the service's default buckets: ``warmup`` runs the wrappers at each
program's throw-away eager run and its capture (plain and masked, every
bucket), and then every deform (one request a bucket, a padded-partial
cloud among them), edit session and drag (Q = 20,000) replays exactly the
kernels of one evaluation, one canonicalisation and one deform
(``SERVE_LAUNCHES``); a drag gives the full deform's answer with the same
conditioning."""
    monkeypatch.setattr(port_graphs, "KEEP_GRAPHS", True)
    want = SERVE_LAUNCHES[name]
    svc = DeformationService(shipped_config(name), device=cuda)
    rng = np.random.RandomState(0)
    surf = rng.randn(5000, 3).astype(np.float32)
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    tgt = (surf + np.float32(0.25)) * handle
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(5000, np.float32)
    pm[-500:] = 0.0  # a padded-partial cloud: padded rows at the origin
    requests = [(3000, None), (10000, None), (20000, pm), (65536, None)]
    queries = {q: rng.uniform(-1.3, 1.3, (q, 3)).astype(np.float32) for q, _ in requests}
    before = launch_counters()
    svc.warmup(5000)
    per_entry = [sum(x) for x in zip(*want.values())]
    assert launched_since(before) == tuple(4 * len(svc.buckets) * x for x in per_entry)
    assert {svc._bucket(q) for q, _ in requests} == set(svc.buckets)
    for q, mask in requests:
        inp = inputs if mask is None else inputs * mask[:, None]
        out, got = replayed(svc.graphs, lambda: svc.deform(queries[q], inp, point_mask=mask),
                            tmp_path)
        assert got == want["deform"] and out.shape == (q, 3) and np.isfinite(out).all(), q
    pts = queries[20000]
    session, got = replayed(svc.graphs, lambda: svc.edit_session(pts, surf), tmp_path)
    assert got == want["session"]
    for scale in (1.0, 0.5):
        out, got = replayed(svc.graphs, lambda: session.drag(tgt * scale, handle), tmp_path)
        assert got == want["drag"] and out.shape == (20000, 3) and np.isfinite(out).all()
    full = svc.deform(pts, np.concatenate([surf, tgt * np.float32(0.5), handle], -1))
    np.testing.assert_allclose(out, full, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STEP_LAUNCHES))
def test_step_replays_launch_one_step_on_the_card(cuda, name, monkeypatch, tmp_path):
    """The shipped nets and both ablations at their published widths
    (N = 5000): the eager first step and the capture each run the wrappers
    for one step, and a replay launches exactly one step's kernels
    (``STEP_LAUNCHES``); a replayed validation batch, the step's forward
    half."""
    monkeypatch.setattr(port_graphs, "KEEP_GRAPHS", True)
    cfg = shipped_config(name)
    model = init_random(build_model(cfg, device=cuda), 0)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    steps = make_steps(model, cfg["model"]["type"], opt, device=cuda)
    batches = _batches(31, 3, N=5000, Q=1024)
    if cfg["model"]["decoder"] == "interp":  # its weights underflow beyond ~2 from every anchor
        for b in batches:
            b["space_samples_src"] = b["surface_samples_inputs"][:, :1024, :3] * np.float32(1.05)
    for batch in batches[:2]:  # the eager first step, then the capture
        before = launch_counters()
        steps["train_step"](batch, 1e-3)
        assert launched_since(before) == STEP_LAUNCHES[name]
    loss, got = replayed([steps["train_step"].graphs],
                         lambda: steps["train_step"](batches[2], 1e-3), tmp_path)
    assert got == STEP_LAUNCHES[name] and np.isfinite(loss)
    validate = lambda: steps["validate_step"](batches[1])
    validate(), validate()  # the signature's eager first call, then its capture
    _, got = replayed([steps["validate_step"].graphs], validate, tmp_path)
    assert got == (STEP_LAUNCHES[name][0], 0, *STEP_LAUNCHES[name][2:])
