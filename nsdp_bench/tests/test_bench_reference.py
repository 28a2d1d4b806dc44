"""The benchmark's reference against the program's plain PyTorch path on the
CPU, at tiny widths, on the benchmark's seeded weights: an evaluation, its
two halves, and three stage-2 train steps (loss, every gradient, every
running statistic, Adam's update), for both configurations.

In float64 the two compute the same function to rounding.  The program
rounds the BatchNorm's Bessel factor to float32 even in float64
(``nsdp_tpu_torch/nn/blocks.py``), so the running variances agree to 1e-7
of their size, not to float64's rounding."""

import json

import numpy as np
import pytest
import torch

from nsdp_bench.reference.model import Adam, Reference, l2_loss
from nsdp_bench.tests.tiny import BENCH, TINY_DECODER, TINY_MODEL
from nsdp_bench.traffic import generate
from nsdp_bench.weights import calibrated_state

CONFIGS = ("nsdp-arbitrary", "nsdp-pointnet2-arbitrary")


def tiny_model(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]
    return dict(cfg, encoder_kwargs=TINY_MODEL[cfg["encoder"]], decoder_kwargs=TINY_DECODER)


def both(name, seed):
    """(model config, the program's model, the reference), float64, on the
    same seeded weights."""
    from nsdp_tpu_torch.models import build_model

    mc = tiny_model(name)
    state = {k: v.double() if v.is_floating_point() else v
             for k, v in calibrated_state(mc, seed, "cpu").items()}
    port = build_model({"model": mc}, device="cpu").double()
    port.load_state_dict(state, strict=True)
    return mc, port, Reference(mc, {k: v.clone() for k, v in state.items()})


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", CONFIGS)
def test_evaluation_matches_the_program(name):
    mc, port, ref = both(name, 11)
    traffic = dict(pool=1, surface_points=64, queries=200, handle_share=0.15, max_shift=0.3,
                   box_margin=0.1)
    r = generate.requests(traffic, 3)[0]
    pts = torch.from_numpy(r["points"]).double()[None]
    inp = torch.from_numpy(r["inputs"]).double()[None]
    with torch.no_grad():
        assert rel(port.predict(pts, inp), ref.predict(pts, inp)) < 1e-12
        sp, su = port.canonicalize(pts, inp[..., :3])
        rp, ru = ref.canonicalize(pts, inp[..., :3])
        assert rel(sp, rp) < 1e-12 and rel(su, ru) < 1e-12
        out = port.deform(sp, su, inp[..., 3:6], inp[..., 6:7])
        assert rel(out, ref.deform(sp, su, inp[..., 3:6], inp[..., 6:7])) < 1e-12


@pytest.mark.parametrize("name", CONFIGS)
def test_three_train_steps_match_the_program(name):
    from nsdp_tpu_torch.training import make_steps, optimizer_factory

    mc, port, ref = both(name, 12)
    traffic = dict(pool=3, batch=2, surface_points=64, space_points=64, handle_share=0.15,
                   max_shift=0.3, box_margin=0.1, falloff=0.5)
    batches = generate.batches(traffic, 4)
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 5e-5}, port.parameters())
    step = make_steps(port, "arbitrary", opt, device="cpu")["train_step"]
    names = [n for n, _ in port.named_parameters()]
    leaves = [ref.p[n].requires_grad_() for n in names]
    adam = Adam(leaves, 5e-5)
    ref.train()
    nought = set()
    # the first step from identical weights agrees to float64 rounding; the
    # later ones start from weights Adam's eps has parted (above)
    for i, b in enumerate(batches):
        tol = 1e-12 if i == 0 else 1e-7
        got = step({k: torch.from_numpy(v).double() for k, v in b.items()}, 5e-5)
        t = {k: torch.from_numpy(v).double() for k, v in b.items()}
        loss = l2_loss(ref.predict(t["space_samples_src"], t["surface_samples_inputs"]),
                       t["space_samples_tgt"])
        grads = torch.autograd.grad(loss, leaves)
        assert abs(got - float(loss.detach())) < tol * abs(float(loss.detach()))
        # a leaf whose gradient vanishes analytically (a shift right before
        # a train-mode BatchNorm) holds rounding: held against the median
        median = float(np.median([float(g.norm()) for g in grads]))
        for n, p, g in zip(names, port.parameters(), grads):
            assert float((p.grad - g).norm()) <= 100 * tol * max(float(g.norm()), median)
            if float(g.norm()) < 1e-3 * median:
                nought.add(n)
        adam.step(grads)
        # such a leaf moves under Adam by round-off alone, up to the rate an
        # element a step (fc_gamma's last bias under the softmax is one);
        # elsewhere Adam's eps (1e-8) turns the rounding of an element's
        # gradient near it into lr / eps = 5000 times as much in its update
        # (a wrong update errs by the rate, 5e-5 an element)
        for n, p in port.named_parameters():
            gap = float((p.detach() - ref.p[n].detach()).norm())
            assert gap <= (6 * 5e-5 * p.numel() ** 0.5 if n in nought
                           else 1e-6 * float(p.detach().norm())), n
        for n, b_ in port.named_buffers():
            if "running" in n:
                assert rel(b_, ref.p[n]) < 1e-7, n


def test_calibration_matches_batch_statistics():
    """After calibration, eval mode on the calibration request is train
    mode on it: every BatchNorm's running statistics are its batch's."""
    mc = tiny_model("nsdp-arbitrary")
    state = calibrated_state(mc, 7, "cpu")
    assert all(float(v.var()) > 0 for k, v in state.items() if k.endswith("running_var"))
    assert not torch.equal(state["model_deform.encoder.fc_middle.0.weight"],
                           calibrated_state(mc, 8, "cpu")["model_deform.encoder.fc_middle.0.weight"])
    again = calibrated_state(mc, 7, "cpu")
    assert all(torch.equal(v, again[k]) for k, v in state.items())
    assert np.isfinite(sum(float(v.double().sum()) for v in state.values()))
