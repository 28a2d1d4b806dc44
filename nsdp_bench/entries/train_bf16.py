"""Stage-2 training with ``compute_dtype: bfloat16``: ``train.py``'s cell
(the same pool in pinned host memory, uploads that do not block, the loss
read one step late, set-up's steps at rate 0 up to the first replay, the
checked replays, the faults ``half_batch`` and ``unchanged``) on a model
whose configuration sets the compute dtype, held against
``reference/bf16.py``, the published model rounding where the setting
says to.

Read from the replayed steps, as in ``train.py``: the first checked
step's loss (``loss_gap``), each leaf's gradient in it (from Adam's first
moment; ``grad_gap``), each leaf's change over the checked steps
(``change_gap``), and the canonicalising encoder's running statistics after
the first checked step (``stats_gap``; ``stats_gap_first``, the same over
its first two BatchNorms alone).  A leaf whose gradient is zero in exact
arithmetic (a bias or shift right before a train-mode BatchNorm,
``fc_gamma``'s last bias) has a bfloat16 gradient of rounding noise, a
few hundredths of the median leaf's, which Adam turns into a full step in
a direction of its own on each side: such leaves are found by the float32
reference's gradient on the first checked batch (under ``NOUGHT`` of the
median leaf's) and left out of the gradient and change readings.

In bfloat16 a float32 difference of one rounding between K1 and the
materialised attention turns a later bfloat16 rounding the other way, and
every train-mode BatchNorm spreads it over its whole batch: by the
encoder's last BatchNorms the statistics differ by ~1e-3 of their norm,
the canonical pose by bfloat16 roundings, the forward net's FPS and kNN
pick other points, and the first step's loss differs by up to ~10%.  So
the loss and the gradients are logged, not compared (``PERF.md``).  The
begin block's BatchNorm and the first set abstraction's ``bn1`` (the first
after a float32 product on the library, its keys and values) come before
that cascade, and there a rounding of the float32 parts stands out
(``stats_gap_first``).

:meth:`Cell.counters` gives ``widened_mib``: the MiB that the program's
counters ``fused_vector_attention.widened_bytes`` and
``BatchNorm.widened_bytes`` grew by over set-up's first step, which runs
eagerly and so passes every call site (a replay passes none); a program
without the counters gives nothing.  :meth:`Cell.work` adds the step's
matrix-product operations by type, counted on the rounding reference.
"""

import json
from typing import Dict, Optional

import numpy as np
import torch

from nsdp_bench.entries import train
from nsdp_bench.reference import bf16
from nsdp_bench.reference.model import Adam, Reference, l2_loss, parameter_spec

# the canonicalising encoder's BatchNorms ahead of the bfloat16 roundings'
# cascade: the begin block's and the first after a float32 product on the
# library (the first set abstraction's, after its float32 keys and values)
FIRST_BATCHNORMS = ("transformer_begin.bn.", "transition_downs.0.sa.bn1.")


def widened_bytes() -> Optional[int]:
    """The program's two widening counters summed, or None if it has
    neither."""
    from nsdp_tpu_torch.nn.blocks import BatchNorm
    from nsdp_tpu_torch.ops.attention import fused_vector_attention

    counts = [getattr(fused_vector_attention, "widened_bytes", None),
              getattr(BatchNorm, "widened_bytes", None)]
    counts = [c for c in counts if c is not None]
    return sum(counts) if counts else None


def norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


class Cell(train.Cell):
    widened: Optional[float] = None
    first_unit = True

    def unit(self, i: int, lr=None) -> int:
        if not self.first_unit:
            return super().unit(i, lr)
        self.first_unit = False
        before = widened_bytes()
        n = super().unit(i, lr)
        after = widened_bytes()
        if before is not None:
            self.widened = (after - before) / 2 ** 20
        return n

    def counters(self) -> Dict[str, float]:
        return {} if self.widened is None else {"widened_mib": self.widened}

    def work(self) -> Dict[str, float]:
        from nsdp_bench import counts

        t = self.traffic
        st = bf16.train_step_counts(self.cfg["model"], t["batch"], t["surface_points"],
                                    t["space_points"])
        return {"flops": st["flops"], "flops_bf16": st["flops_narrow"],
                "flops_f32": st["flops_f32"], "k2_least_ms": counts.k2_least_ms(st["sites"])}

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in self.pool[i % len(self.pool)].items()}

    def nought(self, ref) -> list:
        """Whether each leaf's float32 gradient on the first checked batch
        (the weights are still the seeded ones then) is under ``NOUGHT`` of
        the median leaf's."""
        p = {k: v.clone() for k, v in ref.p.items()}
        f32 = Reference(ref.cfg, p).train()
        leaves = [p[n].requires_grad_() for n in self.names]
        b = self.batch(self.warm)
        grads = torch.autograd.grad(
            l2_loss(f32.predict(b["space_samples_src"], b["surface_samples_inputs"]),
                    b["space_samples_tgt"]), leaves)
        g = [norm(x) for x in grads]
        med = float(np.median(g))
        return [x < train.NOUGHT * med for x in g]

    def readings(self, ref) -> Dict[str, float]:
        trainable = [n for n, _, kind in parameter_spec(self.cfg["model"])
                     if kind in ("weight", "bias", "bn_weight", "bn_bias")]
        if sorted(trainable) != sorted(self.names):
            raise RuntimeError("the program's parameters are not the configuration's")
        nought = self.nought(ref)
        ref = bf16.Reference(ref.cfg, ref.p).train()
        leaves = [ref.p[n].requires_grad_() for n in self.names]
        adam = Adam(leaves, self.lr)
        losses, first_grad, stats, start = [], None, None, None
        for i in range(self.warm + self.traffic["checked_steps"]):
            if i == self.warm:
                start = [p.detach().clone() for p in leaves]
            b = self.batch(i)
            loss = l2_loss(ref.predict(b["space_samples_src"], b["surface_samples_inputs"]),
                           b["space_samples_tgt"])
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if i == self.warm:
                first_grad = [norm(g) for g in grads]
                stats = {n: ref.p[f"model_canonicalize.encoder.{n}"].detach().cpu().clone()
                         for n in self.stats}
            adam.step(grads, lr=0.0 if i < self.warm else self.lr)
            del grads, loss
        sizes = [norm(p.detach() - s) for p, s in zip(leaves, start)]
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(self.program_losses, losses)]
        kept = [i for i, z in enumerate(nought) if not z]
        med = float(np.median([first_grad[i] for i in kept]))
        grad_gaps = [abs(self.first_grad[i] - first_grad[i]) / max(first_grad[i], med)
                     for i in kept]
        med_change = float(np.median([sizes[i] for i in kept]))
        change_gaps = [abs(self.change[i] - sizes[i]) / max(sizes[i], med_change) for i in kept]
        stats_gaps = {n: float((self.stats[n] - stats[n]).norm() / stats[n].norm())
                      for n in self.stats}
        first = [n for n in stats_gaps if n.startswith(FIRST_BATCHNORMS)]
        worst = sorted(stats_gaps, key=stats_gaps.get, reverse=True)[:4]
        self.log("train_bf16: statistics gaps " + json.dumps(
            {n: float(f"{stats_gaps[n]:.3g}") for n in first + worst}))
        self.log(f"train_bf16: {self.warm} step(s) at rate 0 before the first replay; losses "
                 f"program {self.program_losses} reference {losses}; {sum(nought)} of "
                 f"{len(nought)} leaves' float32 gradients nought (under {train.NOUGHT:g} of the "
                 f"median leaf's); worst gradient gap at {self.names[kept[int(np.argmax(grad_gaps))]]}"
                 f", worst change gap at {self.names[kept[int(np.argmax(change_gaps))]]}")
        return {"loss_gap": loss_gaps[self.warm], "loss_gap_warm": max(loss_gaps[:self.warm]),
                "loss_gap_later": max(loss_gaps[self.warm + 1:]), "grad_gap": max(grad_gaps),
                "change_gap": max(change_gaps),
                "stats_gap": max(stats_gaps.values()),
                "stats_gap_first": max(stats_gaps[n] for n in first)}
