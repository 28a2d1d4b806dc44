"""Stage-2 training: ``make_steps(model, "arbitrary", Adam)["train_step"]``
over a pool of seeded batches in pinned host memory, each uploaded without
blocking, the loss read one step late, as ``python -m
nsdp_tpu_torch.train`` runs it.

Set-up builds the model, the optimizer and the steps once and drives them
by the window's own call and feed: first at rate 0 until the step's
program has been captured and replayed (its eager calls and the capture;
one call on the CPU, where nothing is captured), so that the weights stay
the seeded ones, then through ``checked_steps`` steps at the
configuration's rate, each a replay of the captured program that the
window times; the window goes on with the same objects.  The reference
follows every one of those steps (the first ones at rate 0 too) from the
same weights on the same batches.  Compared, all read from the replayed
steps: the first checked step's loss; each leaf's gradient in that step,
as Adam got it (the change of its first moment over the step, over
1 - beta1); each leaf's change over the checked steps; and the running
statistics of the canonicalising encoder after the first checked step,
whose inputs are the batch's own coordinates.  Norms are compared by the
worst leaf: the gap between the program's norm and the reference's, over
the larger of the reference's norm and the median leaf's.
"""

from typing import Dict

import numpy as np
import torch

from nsdp_bench.entries import common
from nsdp_bench.reference.model import Adam, l2_loss, parameter_spec
from nsdp_bench.traffic import generate

BETA1 = 0.9
NOUGHT = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


class Cell(common.Cell):
    def setup(self, state):
        from nsdp_tpu_torch.models import build_model
        from nsdp_tpu_torch.training import make_steps, optimizer_factory

        pin = self.device.type == "cuda"
        self.pool = [{k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                      for k, v in b.items()} for b in generate.batches(self.traffic, self.seed)]
        self.model = build_model({"model": self.cfg["model"]}, device=self.device)
        self.model.load_state_dict(state, strict=True)
        self.lr = self.cfg["training"]["lr"]
        _, self.opt = optimizer_factory(self.cfg["training"], self.model.parameters())
        self.step = make_steps(self.model, self.cfg["model"]["type"], self.opt,
                               device=self.device)["train_step"]
        self.programs = self.make_programs([self.step.graphs])
        self.names = [n for n, _ in self.model.named_parameters()]
        params = list(self.model.parameters())
        self.pending, self.losses, self.warm = None, [], 0
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
                self.first_grad = [float((self.opt.state[p]["exp_avg"] - BETA1 * m).norm())
                                   / (1 - BETA1) for p, m in zip(params, moment)]
                self.stats = {n: b.detach().cpu().clone()
                              for n, b in self.model.model_canonicalize.encoder.named_buffers()
                              if "running" in n}
        self.losses.append(float(self.pending))
        self.pending = None
        self.program_losses = list(self.losses)
        self.change = [float((p.detach() - s).norm()) for p, s in zip(params, start)]
        del start, moment

    def unit(self, i: int, lr=None) -> int:
        """Step on batch ``i`` of the pool at the configuration's rate, or
        at ``lr`` (set-up's steps before the first replay).  The fault
        ``half_batch`` (each batch's second half a copy of its first, so
        that the step's mean is over half the batch) is planted in every
        step but those."""
        b = self.pool[i % len(self.pool)]
        with self.spans("upload"):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in b.items()}
            if self.fault == "half_batch" and lr is None:
                h = len(b["space_samples_src"]) // 2
                batch = {k: torch.cat([v[:h], v[:h], v[2 * h:]]) for k, v in batch.items()}
        if lr is None:
            lr = 0.0 if self.fault == "unchanged" else self.lr
        with self.spans("step"):
            t0 = self.clock()
            loss = self.step(batch, lr, fetch=False)
        if self.pending is not None:
            with self.spans("loss_read"):
                self.losses.append(float(self.pending))
        self.calls.append((self.clock() - t0, self.spans.on, "step"))
        self.pending = loss
        return 1

    def e2e(self, window) -> Dict[str, float]:
        return {"train_step_ms": 1e3 * window.seconds / len(window.units)}

    def failed(self) -> int:
        return sum(not np.isfinite(v) for v in self.losses)

    def release(self):
        del self.model, self.opt, self.step, self.programs, self.pending
        self.flush()

    def work(self) -> Dict[str, float]:
        from nsdp_bench import counts

        t = self.traffic
        st = counts.train_step(self.cfg["model"], t["batch"], t["surface_points"],
                               t["space_points"])
        return {"flops": st["flops"], "k2_least_ms": counts.k2_least_ms(st["sites"])}

    def readings(self, ref) -> Dict[str, float]:
        trainable = [n for n, _, kind in parameter_spec(self.cfg["model"])
                     if kind in ("weight", "bias", "bn_weight", "bn_bias")]
        if sorted(trainable) != sorted(self.names):
            raise RuntimeError("the program's parameters are not the configuration's")
        leaves = [ref.p[n].requires_grad_() for n in self.names]
        adam = Adam(leaves, self.lr)
        ref.train()
        losses, first_grad, stats, start = [], None, None, None
        for i in range(self.warm + self.traffic["checked_steps"]):
            if i == self.warm:
                start = [p.detach().clone() for p in leaves]
            b = {k: v.to(self.device) for k, v in self.pool[i % len(self.pool)].items()}
            loss = l2_loss(ref.predict(b["space_samples_src"], b["surface_samples_inputs"]),
                           b["space_samples_tgt"])
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss))
            if i == self.warm:
                first_grad = [float(g.norm()) for g in grads]
                stats = {n: ref.p[f"model_canonicalize.encoder.{n}"].detach().cpu().clone()
                         for n in self.stats}
            adam.step(grads, lr=0.0 if i < self.warm else self.lr)
            del grads, loss
        change = [float((p.detach() - s).norm()) for p, s in zip(leaves, start)]
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(self.program_losses, losses)]
        med = float(np.median(first_grad))
        grad_gaps = [abs(a - c) / max(c, med) for a, c in zip(self.first_grad, first_grad)]
        moved = [i for i, g in enumerate(first_grad) if g >= NOUGHT * med]
        med_change = float(np.median([change[i] for i in moved]))
        change_gaps = [abs(self.change[i] - change[i]) / max(change[i], med_change) for i in moved]
        stats_gap = max(float((self.stats[n] - stats[n]).norm() / stats[n].norm())
                        for n in self.stats)
        worst = int(np.argmax(change_gaps))
        self.log(f"train: {self.warm} step(s) at rate 0 before the first replay; losses program "
                 f"{self.program_losses} reference {losses}; {len(first_grad) - len(moved)} of "
                 f"{len(first_grad)} leaves' gradients nought (under {NOUGHT:g} of the median "
                 f"leaf's); worst gradient gap at {self.names[int(np.argmax(grad_gaps))]}, worst "
                 f"change gap at {self.names[moved[worst]]}")
        return {"loss_gap": loss_gaps[self.warm], "loss_gap_warm": max(loss_gaps[:self.warm]),
                "loss_gap_later": max(loss_gaps[self.warm + 1:]), "grad_gap": max(grad_gaps),
                "change_gap": max(change_gaps), "stats_gap": stats_gap}
