"""The bfloat16 cell (``arbitrary-train-stage2-b8-bf16``) on the CPU at tiny
widths: the rounding reference (``reference/bf16.py``) against the port's
plain path, the cell's readings against a float32 reference and against a
program that rounds its float32 parts, its operation counts, and the cell
driven whole through ``run_cell(..., device="cpu")`` in a checkout of its
own.

One stage-2 step from the seeded, calibrated weights, the port's
``make_steps`` against the reference on the same batch.  On the CPU both
sides compute the bfloat16 layers with the same torch kernels, so the
forward agrees bit for bit unless the float32 attention (the port's plain
kernel against the materialised reference) differs by a rounding that
turns a later bfloat16 rounding the other way.  The backward adds the
bfloat16 gradients of a tensor used twice in another order on each side
(a set abstraction's features feed its centres and its keys and values),
and each such sum rounds.  The tolerances, each with the largest reading
over the 10 of seeds 0-11 and 2147483659 whose forward agreed:

* the loss, relative: 0 on every seed (``LOSS_RTOL``);
* a leaf's gradient, over the larger of its norm and the median leaf's,
  where the float32 gradient is not nought: 0.042; against the float32
  reference 1.84 or more (``GRAD_TOL``);
* each running statistic after the step, by its norm: 1.8e-7, the same
  batch statistics summed in another order (``STATS_RTOL``);
* a leaf's change, against the reference's Adam on the port's own
  gradient, over the larger of its norm and the median change: 0 on every
  seed; the change is a difference of float32 weights near 1 that moved
  by about lr = 5e-5, so an element may carry up to ulp(1) / lr = 2.4e-3
  of rounding (``CHANGE_RTOL``).

So the step's seed is fixed (``STEP_SEED``).  On seeds 0, 7 and
2147483659 a one-ulp float32 difference between the two attentions
(seed 0: 1.2e-7 in the canonicalising encoder's begin block) turned one
or two of its bfloat16 outputs the other way, and the train-mode
BatchNorms spread that through the net: the two sides' steps then part
as far as bfloat16 and float32 do.  That is the cascade the cell's
readings are built around (``entries/train_bf16.py``), not an error of
either side.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from nsdp_bench import counts
from nsdp_bench.entries import train_bf16
from nsdp_bench.harness import Spans
from nsdp_bench.reference import bf16
from nsdp_bench.reference.model import Adam, Reference, l2_loss
from nsdp_bench.tests import tiny
from nsdp_bench.traffic import generate
from nsdp_bench.weights import calibrated_state

CELL = "arbitrary-train-stage2-b8-bf16"
CONFIG = tiny.BENCH / "configs" / "nsdp-arbitrary-bf16.json"
TRAFFIC = tiny.BENCH / "traffic" / "train-stage2-b8-bf16.json"
LIMITS = json.loads((tiny.BENCH / "limits" / f"{CELL}.json").read_text())
SEED = 2147483659  # as large as the benchmark's seeds, past 32 signed bits
STEP_SEED = 1

LOSS_RTOL = 1e-6
GRAD_TOL = 0.15
STATS_RTOL = 2e-6
CHANGE_RTOL = 2.4e-3
NOUGHT = 1e-3  # entries/train.py's: a leaf whose float32 gradient is under this share of the median


def tiny_cfg(**model):
    cfg = json.loads(CONFIG.read_text())
    cfg["model"].update(encoder_kwargs=tiny.TINY_MODEL[cfg["model"]["encoder"]],
                        decoder_kwargs=tiny.TINY_DECODER, **model)
    return cfg


def tiny_traffic():
    return dict(json.loads(TRAFFIC.read_text()), **tiny.TINY_TRAFFIC["train"])


def norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def one_step(seed: int):
    """The port's bfloat16 step and the references' on one batch from the
    seeded weights -> a dict of what the tests compare."""
    from nsdp_tpu_torch.models import build_model
    from nsdp_tpu_torch.training import make_steps, optimizer_factory

    cfg = tiny_cfg()
    lr = cfg["training"]["lr"]
    state = calibrated_state(cfg["model"], seed, "cpu")
    model = build_model({"model": cfg["model"]}, device="cpu")
    model.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    step = make_steps(model, "arbitrary", opt, device="cpu")["train_step"]
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    b = generate.batches(tiny_traffic(), seed)[0]
    before = [p.detach().clone() for p in params]
    loss = step(b, lr)
    out = {"names": names, "loss": loss, "grads": [p.grad.clone() for p in params],
           "change": [p.detach() - w for p, w in zip(params, before)],
           "buffers": {n: t for n, t in model.named_buffers() if "running" in n}}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for label, reference in (("ref", bf16.Reference), ("f32", Reference)):
        p = {k: v.clone() for k, v in state.items()}
        ref = reference(cfg["model"], p).train()
        leaves = [p[n].requires_grad_() for n in names]
        want = l2_loss(ref.predict(tb["space_samples_src"], tb["surface_samples_inputs"]),
                       tb["space_samples_tgt"])
        out[label] = {"loss": float(want.detach()), "grads": torch.autograd.grad(want, leaves),
                      "buffers": p}
    # the reference's Adam on the port's gradient, from the same state
    adam = Adam([w.clone() for w in before], lr)
    adam.step(out["grads"])
    out["adam_change"] = [a - w for a, w in zip(adam.params, before)]
    return out


def gaps(got, want, names, f32_grads):
    """Each leaf's gradient gap over the larger of its norm and the median
    leaf's, where the float32 gradient is not nought."""
    g32 = [norm(g) for g in f32_grads]
    med32 = float(np.median(g32))
    kept = [i for i, g in enumerate(g32) if g >= NOUGHT * med32]
    med = float(np.median([norm(want[i]) for i in kept]))
    return {names[i]: norm(got[i] - want[i]) / max(norm(want[i]), med) for i in kept}


@pytest.fixture(scope="module")
def step():
    return one_step(STEP_SEED)


def test_the_rounding_reference_holds_the_port_step(step):
    ref = step["ref"]
    assert abs(step["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    grad = gaps(step["grads"], ref["grads"], step["names"], step["f32"]["grads"])
    assert max(grad.values()) <= GRAD_TOL, max(grad.items(), key=lambda kv: kv[1])
    for n, b in step["buffers"].items():
        assert norm(b - ref["buffers"][n]) <= STATS_RTOL * norm(ref["buffers"][n]), n
    med = float(np.median([norm(c) for c in step["adam_change"]]))
    for n, got, want in zip(step["names"], step["change"], step["adam_change"]):
        assert norm(got - want) <= CHANGE_RTOL * max(norm(want), med), n


def test_the_rounding_reference_tells_bfloat16_from_float32(step):
    """The float32 reference misses the port's bfloat16 step by far more
    than the tolerances: the loss, the worst leaf's gradient, the running
    statistics."""
    f32 = step["f32"]
    assert abs(step["loss"] - f32["loss"]) > 100 * LOSS_RTOL * abs(f32["loss"])
    grad = gaps(step["grads"], f32["grads"], step["names"], f32["grads"])
    assert max(grad.values()) > 3 * GRAD_TOL
    assert max(norm(b - f32["buffers"][n]) / norm(f32["buffers"][n])
               for n, b in step["buffers"].items()) > 100 * STATS_RTOL


def test_the_step_counts_split_by_type():
    """At the published widths the bfloat16 and float32 products add up to
    the float32 model's count (``counts.train_step``, torch's own flop
    counter), and the attention sites are the float32 model's."""
    model_cfg = json.loads(CONFIG.read_text())["model"]
    st = bf16.train_step_counts(model_cfg, 8, 5000, 5000)
    f32 = counts.train_step(model_cfg, 8, 5000, 5000)
    assert st["sites"] == f32["sites"] and len(st["sites"]) == 17
    assert st["flops_narrow"] + st["flops_f32"] == st["flops"]
    assert st["flops"] == pytest.approx(f32["flops"], rel=1e-12)
    assert 0 < st["flops_narrow"] < st["flops"]


@pytest.fixture(scope="module")
def entry():
    """The cell's entry set up on the CPU at tiny widths (its steps at
    rate 0 and its checked steps), with its seeded weights."""
    cfg = tiny_cfg()
    state = calibrated_state(cfg["model"], SEED, "cpu")
    initial = {k: v.clone() for k, v in state.items()}
    cell = train_bf16.Cell(cfg, tiny_traffic(), SEED, "cpu", Spans())
    cell.setup(state)
    cell.release()
    return cell, initial


def readings(cell, initial):
    return cell.readings(Reference(cell.cfg["model"], {k: v.clone() for k, v in initial.items()}))


def test_the_readings_pass_the_port_and_refuse_a_float32_reference(entry, monkeypatch):
    """The cell's readings of the port's bfloat16 steps pass every limit
    against the rounding reference; against the float32 reference they are
    refused by the limit that reads the precision, ``stats_gap_first``
    (``change_gap``'s limit lies between a sound run's reading and an
    unchanged state's 1, where Adam's steps of about the learning rate put
    a float32 model's change too)."""
    cell, initial = entry
    sound = readings(cell, initial)
    assert all(sound[k] <= v for k, v in LIMITS.items()), sound
    monkeypatch.setattr(bf16, "Reference", Reference)
    f32 = readings(cell, initial)
    assert f32["stats_gap_first"] > 10 * LIMITS["stats_gap_first"], f32
    assert cell.counters()["widened_mib"] > 0


def round_attention(monkeypatch):
    """The kNN attention's output rounded to bfloat16 (its float32 part
    computed at bfloat16's precision)."""
    from nsdp_tpu_torch.ops import attention

    plain = attention.fused_vector_attention_plain
    monkeypatch.setattr(attention, "fused_vector_attention_plain",
                        lambda *a, **kw: plain(*a, **kw).to(torch.bfloat16).float())


def round_batchnorm(monkeypatch):
    """Train-mode BatchNorm normalising with, and keeping, batch statistics
    rounded to bfloat16."""
    from nsdp_tpu_torch.nn.blocks import BatchNorm

    exact = BatchNorm.forward

    def forward(self, x, mask=None):
        if not self.training or mask is not None:
            return exact(self, x, mask)
        flat = x.float().reshape(-1, x.shape[-1])
        rnd = lambda t: t.to(torch.bfloat16).float()
        mean = rnd(flat.mean(dim=0))
        var = rnd(torch.square(flat - mean).mean(dim=0))
        with torch.no_grad():
            n = flat.shape[0]
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * var * n / (n - 1))
            self.num_batches_tracked.add_(1)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.dtype or x.dtype)

    monkeypatch.setattr(BatchNorm, "forward", forward)


@pytest.mark.parametrize("rounding", [round_attention, round_batchnorm],
                         ids=["attention", "batchnorm"])
def test_the_readings_refuse_a_program_whose_float32_parts_round(rounding, monkeypatch):
    """A precision below the configuration's: the program's float32
    attention, or its BatchNorm statistics, rounded to bfloat16."""
    rounding(monkeypatch)
    cfg = tiny_cfg()
    state = calibrated_state(cfg["model"], SEED, "cpu")
    initial = {k: v.clone() for k, v in state.items()}
    cell = train_bf16.Cell(cfg, tiny_traffic(), SEED, "cpu", Spans())
    cell.setup(state)
    cell.release()
    got = readings(cell, initial)
    assert any(got[k] > v for k, v in LIMITS.items()), got


def test_a_float32_model_widens_nothing():
    """The entry's ``widened_mib`` on the float32 configuration's model
    (the same cell without ``compute_dtype``) is 0."""
    cfg = tiny_cfg()
    del cfg["model"]["compute_dtype"]
    cell = train_bf16.Cell(cfg, tiny_traffic(), SEED, "cpu", Spans())
    cell.setup(calibrated_state(cfg["model"], SEED, "cpu"))
    cell.release()
    assert cell.counters() == {"widened_mib": 0.0}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The cell's own tiny checkout -> its root: the configuration's widths
    and the traffic's sizes cut to ``tiny``'s, every other key and every
    limit kept."""
    root = tmp_path_factory.mktemp("bf16_checkout")
    shutil.copytree(tiny.BENCH, root / "nsdp_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "nsdp_bench" / "configs" / CONFIG.name).write_text(json.dumps(tiny_cfg()))
    (root / "nsdp_bench" / "traffic" / TRAFFIC.name).write_text(json.dumps(tiny_traffic()))
    shutil.copy(tiny.REPO / "BENCHMARK.json", root)
    return root


@pytest.mark.parametrize("fault,correct", [(None, True), ("half_batch", False),
                                           ("unchanged", False)])
def test_the_cell_catches_its_faults(checkout, fault, correct):
    """A sound run (traced) is correct and reports the cell's per-layer
    metrics; a step over half the batch, or one that leaves the state
    unchanged, is not correct."""
    traced = fault is None
    result = tiny.run(checkout, CELL, seed=SEED, trace=traced, fault=fault)
    assert result["correct"] is correct, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(LIMITS)
    if traced:
        metrics = {k: v["value"] for k, v in result["metrics"].items()}
        assert metrics["widened_mib.train_bf16"] > 0
        assert 0 < metrics["mfu_pct.train_bf16"] < 100
    else:
        assert set(result["metrics"]) == {"train_step_ms", "peak_reserved_gib", "setup_s"}
