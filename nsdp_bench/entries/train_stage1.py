"""Stage-1 training: ``make_steps(model, "forward", Adam)["train_step"]``,
the handle-conditioned forward net alone, as ``python -m
nsdp_tpu_torch.train`` runs ``configs/deform4d/forward.yaml``.

``train.py``'s cell on the forward net: the same pool in pinned host
memory, uploads that do not block, the loss read one step late, set-up's
steps at rate 0 up to the first replay, the checked replays, the faults
``half_batch`` and ``unchanged``.  The configuration's ``model`` block
says ``type: "arbitrary"``, since the harness draws and calibrates weights
for that composition alone; its ``trained_net`` names the type built here
and the prefix of the drawn weights it loads, strict: FlowArbitrary's
``model_deform`` is this same net.  Compared, as in ``train.py``, against
``reference/stage1.py``: the first checked step's loss, each leaf's
gradient in it (from Adam's first moment), each leaf's change over the
checked steps, and the forward encoder's running statistics after the
first checked step (its inputs are the batch's own conditioning).

In a traced run the program's tracer (``nsdp_tpu_torch.utils.profiling``)
is on from the first profiled slice to the end of the window;
:meth:`Cell.counters` then gives ``host_step_ms``, the mean ``train.step``
span over the steps outside the slices.  A run with ``--trace 0`` never
turns the tracer on.
"""

from typing import Dict

import numpy as np
import torch

from nsdp_bench import program_spans
from nsdp_bench.entries import train
from nsdp_bench.reference import stage1
from nsdp_bench.reference.model import Adam
from nsdp_bench.traffic import generate


class Cell(train.Cell):
    def setup(self, state):
        from nsdp_tpu_torch.models import build_model
        from nsdp_tpu_torch.training import make_steps, optimizer_factory

        net = self.cfg["trained_net"]
        prefix = net["prefix"]
        state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        pin = self.device.type == "cuda"
        self.pool = [{k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                      for k, v in b.items()} for b in generate.batches(self.traffic, self.seed)]
        self.model = build_model({"model": dict(self.cfg["model"], type=net["type"])},
                                 device=self.device)
        self.model.load_state_dict(state, strict=True)
        del state
        self.lr = self.cfg["training"]["lr"]
        _, self.opt = optimizer_factory(self.cfg["training"], self.model.parameters())
        self.step = make_steps(self.model, net["type"], self.opt, device=self.device)["train_step"]
        self.programs = self.make_programs([self.step.graphs])
        self.names = [n for n, _ in self.model.named_parameters()]
        params = list(self.model.parameters())
        self.pending, self.losses, self.warm = None, [], 0
        self.tracer, self.in_slice, self.read = program_spans.tracer(), None, None
        graphs = self.step.graphs
        while True:  # rate 0 up to the first replay (one call where nothing is captured)
            self.programs.call(lambda: self.unit(self.warm, lr=0.0))
            self.warm += 1
            if graphs is None or graphs.summary()["replays"] > 0:
                break
        moment = [self.opt.state[p]["exp_avg"].clone() for p in params]
        start = [p.detach().clone() for p in params]
        for i in range(self.warm, self.warm + self.traffic["checked_steps"]):
            self.programs.call(lambda: self.unit(i))
            if i == self.warm:
                self.first_grad = [float((self.opt.state[p]["exp_avg"] - train.BETA1 * m).norm())
                                   / (1 - train.BETA1) for p, m in zip(params, moment)]
                self.stats = {n: b.detach().cpu().clone()
                              for n, b in self.model.encoder.named_buffers() if "running" in n}
        self.losses.append(float(self.pending))
        self.pending = None
        self.program_losses = list(self.losses)
        self.change = [float((p.detach() - s).norm()) for p, s in zip(params, start)]
        del start, moment

    def unit(self, i: int, lr=None) -> int:
        if self.in_slice is None and self.spans.on and self.tracer is not None:
            self.in_slice = []
            self.tracer.start_tracing()
        n = super().unit(i, lr)
        if self.in_slice is not None:
            self.in_slice.append(self.spans.on)
        return n

    def counters(self) -> Dict[str, float]:
        if self.read is None:
            self.read = {}
            if self.in_slice is not None:
                self.tracer.stop_tracing()
                spans, _ = self.tracer.drain()
                ms = program_spans.host_bound_ms(spans, ("train.step",), self.in_slice)
                if ms is not None:
                    self.read["host_step_ms"] = ms
        return self.read

    def release(self):
        if self.in_slice is not None:
            self.tracer.stop_tracing()
        super().release()

    def work(self) -> Dict[str, float]:
        from nsdp_bench import counts

        t = self.traffic
        st = stage1.train_step_counts(self.cfg["model"], t["batch"], t["surface_points"],
                                      t["space_points"])
        return {"flops": st["flops"], "k2_least_ms": counts.k2_least_ms(st["sites"])}

    def readings(self, ref) -> Dict[str, float]:
        if sorted(stage1.trainable(self.cfg["model"])) != sorted(self.names):
            raise RuntimeError("the program's parameters are not the configuration's forward net's")
        leaves = [ref.p[f"{stage1.NET}.{n}"].requires_grad_() for n in self.names]
        adam = Adam(leaves, self.lr)
        ref.train()
        losses, first_grad, stats, start = [], None, None, None
        for i in range(self.warm + self.traffic["checked_steps"]):
            if i == self.warm:
                start = [p.detach().clone() for p in leaves]
            b = {k: v.to(self.device) for k, v in self.pool[i % len(self.pool)].items()}
            loss = stage1.loss(ref, b)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if i == self.warm:
                first_grad = [float(g.norm()) for g in grads]
                stats = {n: ref.p[f"{stage1.NET}.encoder.{n}"].detach().cpu().clone()
                         for n in self.stats}
            adam.step(grads, lr=0.0 if i < self.warm else self.lr)
            del grads, loss
        change = [float((p.detach() - s).norm()) for p, s in zip(leaves, start)]
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(self.program_losses, losses)]
        med = float(np.median(first_grad))
        grad_gaps = [abs(a - c) / max(c, med) for a, c in zip(self.first_grad, first_grad)]
        moved = [i for i, g in enumerate(first_grad) if g >= train.NOUGHT * med]
        med_change = float(np.median([change[i] for i in moved]))
        change_gaps = [abs(self.change[i] - change[i]) / max(change[i], med_change) for i in moved]
        stats_gap = max(float((self.stats[n] - stats[n]).norm() / stats[n].norm())
                        for n in self.stats)
        worst = int(np.argmax(change_gaps))
        self.log(f"train_stage1: {self.warm} step(s) at rate 0 before the first replay; losses "
                 f"program {self.program_losses} reference {losses}; {len(first_grad) - len(moved)}"
                 f" of {len(first_grad)} leaves' gradients nought (under {train.NOUGHT:g} of the "
                 f"median leaf's); worst gradient gap at {self.names[int(np.argmax(grad_gaps))]}, "
                 f"worst change gap at {self.names[moved[worst]]}")
        return {"loss_gap": loss_gaps[self.warm], "loss_gap_warm": max(loss_gaps[:self.warm]),
                "loss_gap_later": max(loss_gaps[self.warm + 1:]), "grad_gap": max(grad_gaps),
                "change_gap": max(change_gaps), "stats_gap": stats_gap}
