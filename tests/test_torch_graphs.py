"""Captured programs (``nsdp_tpu_torch.graphs``) in serving and training.

On the CPU a program keeps the captured path's static-buffer contract
(its outputs are overwritten by the next call of any program of its
``Graphs``) and runs the function directly, so these tests show that the
serving and training paths keep nothing a later call overwrites, and that
the captured-contract step is the eager step bit for bit.  The ``gpu``
tests hold the captured programs against the eager path on the card, at a
small size.  The module imports nothing of JAX, so it also runs on the
card:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs.py
"""

import copy
import re
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from nsdp_tpu_torch.graphs import Graphs
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.training import make_steps, optimizer_factory

ENC_KW = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nneighbor_reduced=4,
              nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True)
DEC_KW = dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3)
PNPP_KW = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nfinal_transformers=1,
               d_transformer=16)


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


def _batches(seed, n, B=2, N=32, Q=12, masked=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rng.randn(B, N, 3).astype(np.float32)
        handle = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
        batch = {"surface_samples_inputs": np.concatenate(
                     [src, rng.randn(B, N, 3).astype(np.float32) * handle, handle], -1),
                 "space_samples_src": rng.randn(B, Q, 3).astype(np.float32),
                 "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32)}
        if masked:
            valid = np.ones((B, N), np.float32)
            valid[:, -5:] = 0.0
            batch["surface_samples_inputs"] *= valid[..., None]
            batch["surface_valid_mask"] = valid
        out.append(batch)
    return out


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_grouped_step_stays_eager():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        model = init_random(build_model(config("forward"), device="cpu"), 0)
        _, opt = optimizer_factory({"lr": 1e-3}, model.parameters())
        with pytest.raises(ValueError, match="group"):
            make_steps(model, "forward", opt, device="cpu", group=dist.group.WORLD, graphs=True)
        steps = make_steps(model, "forward", opt, device="cpu", group=dist.group.WORLD)
        assert steps["train_step"].graphs is None
        assert np.isfinite(steps["train_step"](_batches(4, 1)[0], 1e-3))
    finally:
        dist.destroy_process_group()


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
    losses = [s["train_step"](batches[2], 1e-3) for s in (steps, twins[0][2], twins[1][2])]
    assert losses[0] == losses[1]
    for a, b in zip(model.buffers(), twins[0][0].buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    (c, _, _), (e, _, _), (e2, _, _) = (_state(m, o) for m, o, _ in [(model, opt, 0), *twins])
    for got, want, again in [*zip(c[0], e[0], e2[0]), *zip(c[1], e[1], e2[1])]:
        if not torch.equal(got, want):
            gap = float(torch.linalg.vector_norm((got - want).double())
                        / torch.linalg.vector_norm(want.double()))
            noise = float(torch.linalg.vector_norm((again - want).double())
                          / torch.linalg.vector_norm(want.double()))
            assert gap <= max(4 * noise, 1e-4)
