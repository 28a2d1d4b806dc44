"""The port's in-process tracer (``nsdp_tpu_torch.utils.profiling``), on the
CPU: off, a span site is a shared no-op and nothing is recorded across a
``deform`` and a ``train_step``; on, the serving entries and the train
step record their spans nested in time under one root and one request id
per call, with the query rows counted; ``trace_steps`` writes the spans
into its Chrome trace, on the trace's clock."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.training import make_steps, optimizer_factory
from nsdp_tpu_torch.utils import profiling

ENC_KW = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nneighbor_reduced=4,
              nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True)
DEC_KW = dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3)
CONFIG = {"model": {"type": "arbitrary", "use_normals": False, "encoder": "pointransformer",
                    "encoder_kwargs": ENC_KW, "decoder": "crossatten", "decoder_kwargs": DEC_KW},
          "training": {"optimizer": "Adam", "lr": 1e-3}}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    profiling.stop_tracing()
    profiling.drain()
    yield
    profiling.stop_tracing()
    profiling.drain()


@pytest.fixture(scope="module")
def service():
    return DeformationService(CONFIG, device="cpu", graphs=True)


@pytest.fixture(scope="module")
def steps():
    model = build_model(CONFIG, device="cpu")
    init_random(model, 0)
    _, opt = optimizer_factory(CONFIG["training"], model.parameters())
    return make_steps(model, "arbitrary", opt, device="cpu", graphs=True)


def surface(rng, n=32):
    src = rng.randn(n, 3).astype(np.float32)
    handle = (rng.rand(n, 1) > 0.5).astype(np.float32)
    return src, rng.randn(n, 3).astype(np.float32) * handle, handle


def batch(rng, B=2, N=32, Q=12):
    src = rng.randn(B, N, 3).astype(np.float32)
    handle = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    inputs = np.concatenate([src, (src + 0.1) * handle, handle], -1)
    space = rng.randn(B, Q, 3).astype(np.float32)
    return {"surface_samples_inputs": inputs, "space_samples_src": space,
            "space_samples_tgt": space + 0.05}


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def nested(spans, root):
    """Every span of ``spans`` lies in time inside its parent, and its
    parents lead to ``root``."""
    ids = {s.id: s for s in spans}
    for s in spans:
        if s is root:
            continue
        parent = ids[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, (s, parent)
        while parent.parent is not None:
            parent = ids[parent.parent]
        assert parent is root, s


def test_off_records_nothing(service, steps):
    assert not profiling.tracing()
    assert profiling.span("serve.deform") is profiling.span("graphs.replay", "deform")
    rng = np.random.RandomState(0)
    src, tgt, handle = surface(rng)
    inputs = np.concatenate([src, tgt, handle], -1)
    service.deform(rng.randn(50, 3).astype(np.float32), inputs)
    steps["train_step"](batch(rng), 1e-3)
    profiling.count("serve.rows_valid", 50)
    assert profiling.drain() == ([], [])


def test_deform_spans_one_request(service):
    rng = np.random.RandomState(1)
    src, tgt, handle = surface(rng)
    inputs = np.concatenate([src, tgt, handle], -1)
    points = rng.randn(3000, 3).astype(np.float32)
    profiling.start_tracing()
    out = service.deform(points, inputs)
    profiling.stop_tracing()
    spans, counts = profiling.drain()
    assert out.shape == (3000, 3)
    names = by_name(spans)
    (root,) = names["serve.deform"]
    assert root.parent is None
    assert {s.request for s in spans} == {root.request}
    assert {"serve.pad", "serve.wait", "serve.fetch", "graphs.stage", "graphs.eager"} <= set(names)
    assert {s.detail for s in names["graphs.stage"] + names["graphs.eager"]} == {"deform"}
    nested(spans, root)
    pad, wait, fetch = names["serve.pad"][0], names["serve.wait"][0], names["serve.fetch"][0]
    assert pad.end_ns <= names["graphs.stage"][0].start_ns and wait.parent == fetch.id
    assert profiling.totals(counts) == {"serve.rows_valid": 3000, "serve.rows_padded": 4096}
    assert {c.request for c in counts} == {root.request}


def test_session_and_drag_roots(service):
    rng = np.random.RandomState(2)
    src, tgt, handle = surface(rng)
    profiling.start_tracing()
    session = service.edit_session(rng.randn(100, 3).astype(np.float32), src)
    session.drag(tgt, handle)
    session.drag(tgt * 0.5, handle)
    spans, counts = profiling.drain()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in sorted(roots, key=lambda s: s.start_ns)] == [
        "serve.open", "serve.drag", "serve.drag"]
    assert len({s.request for s in roots}) == 3
    for root in roots:
        mine = [s for s in spans if s.request == root.request]
        nested(mine, root)
        details = {s.detail for s in mine if s.name.startswith("graphs.")}
        assert details == {"canonicalize" if root.name == "serve.open" else "drag"}
    assert "serve.wait" not in {s.name for s in spans if s.request == roots[0].request}
    assert profiling.totals(counts) == {"serve.rows_valid": 300, "serve.rows_padded": 3 * 4096}


def test_train_step_spans(steps):
    rng = np.random.RandomState(3)
    profiling.start_tracing()
    loss = steps["train_step"](batch(rng), 1e-3, fetch=False)
    spans, counts = profiling.drain()
    assert torch.is_tensor(loss) and counts == []
    names = by_name(spans)
    (root,) = names["train.step"]
    assert root.parent is None and {s.request for s in spans} == {root.request}
    assert {"train.inputs", "train.optimizer", "train.loss", "graphs.stage",
            "graphs.eager"} <= set(names)
    assert {s.detail for s in names["graphs.eager"]} == {"train_step"}
    nested(spans, root)
    first = lambda n: names[n][0].start_ns
    assert first("train.inputs") < first("graphs.stage") < first("train.optimizer") \
        < first("train.loss")


@pytest.mark.parametrize("model_type", ["forward", "arbitrary"])
def test_train_step_span_names_the_model_type(model_type):
    """A trace of ``python -m nsdp_tpu_torch.train`` tells stage-1 steps
    from stage-2 steps by the ``train.step`` span's detail."""
    cfg = {**CONFIG, "model": {**CONFIG["model"], "type": model_type}}
    model = init_random(build_model(cfg, device="cpu"), 0)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    step = make_steps(model, model_type, opt, device="cpu")["train_step"]
    profiling.start_tracing()
    step(batch(np.random.RandomState(5)), 1e-3)
    spans, _ = profiling.drain()
    (root,) = by_name(spans)["train.step"]
    assert root.detail == model_type
    assert {s.detail for s in spans if s.name.startswith("train.") and s is not root} == {None}


@pytest.mark.parametrize("compute_dtype,detail", [(None, "arbitrary"), ("float32", "arbitrary"),
                                                  ("bfloat16", "arbitrary bfloat16")])
def test_train_step_span_names_the_compute_dtype(compute_dtype, detail):
    """The ``train.step`` detail carries the model's compute dtype where
    one is set, so a trace tells bfloat16 steps from float32 ones; a
    float32 model's detail is the model type alone, as before."""
    model_cfg = dict(CONFIG["model"])
    if compute_dtype is not None:
        model_cfg["compute_dtype"] = compute_dtype
    model = init_random(build_model({**CONFIG, "model": model_cfg}, device="cpu"), 0)
    _, opt = optimizer_factory(CONFIG["training"], model.parameters())
    step = make_steps(model, "arbitrary", opt, device="cpu")["train_step"]
    profiling.start_tracing()
    step(batch(np.random.RandomState(5)), 1e-3)
    spans, _ = profiling.drain()
    (root,) = by_name(spans)["train.step"]
    assert root.detail == detail


def test_threads_keep_their_own_roots():
    profiling.start_tracing()
    with profiling.span("outer"):
        worker = threading.Thread(target=lambda: profiling.span("other").__enter__().__exit__())
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    spans, _ = profiling.drain()
    names = by_name(spans)
    assert names["other"][0].parent is None
    assert names["other"][0].request != names["outer"][0].request


def test_trace_steps_writes_spans_on_its_clock(tmp_path, steps):
    rng = np.random.RandomState(4)
    with profiling.trace_steps(str(tmp_path)):
        steps["train_step"](batch(rng), 1e-3)
    assert not profiling.tracing() and profiling.drain() == ([], [])
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "nsdp"]
    step = next(e for e in ours if e["name"] == "train.step")
    assert {"train.inputs", "train.optimizer", "train.loss", "graphs.eager"} <= {
        e["name"] for e in ours}
    # the optimizer's update, a profiler record of its own, lies inside the
    # span that covers it once both are on the trace's clock
    opt = next(e for e in ours if e["name"] == "train.optimizer")
    inside = [e for e in events if e.get("ph") == "X" and e.get("cat") != "nsdp"
              and "Optimizer.step" in e.get("name", "")]
    assert inside, "the profiler recorded no optimizer step"
    for e in inside:
        assert opt["ts"] - 50 <= e["ts"] and e["ts"] + e["dur"] <= opt["ts"] + opt["dur"] + 50
    assert step["ts"] <= opt["ts"] and opt["ts"] + opt["dur"] <= step["ts"] + step["dur"]
