"""Optimizers and learning-rate schedules (counterpart of
``nsdp_tpu/training/optim.py``; reference ``model/__init__.py:10-41``,
``model/learningrate.py:17-34``).

The learning rate steps per epoch, ``lr = initial * factor ** (epoch //
interval)``; the training step writes the epoch's rate into the
optimizer's ``param_groups``.  Weight decay is torch's own: L2 added to the
gradient before the update.  ``clip_grad`` clamps every gradient element to
``[-clip_grad, clip_grad]`` before the step, ahead of the weight decay, as
the JAX package's ``optax.clip`` does.
"""

from typing import Any, Dict, Iterable, Tuple

import torch


class StepLearningRateSchedule:
    """lr(epoch) = initial * factor ** (epoch // interval)."""

    def __init__(self, specs: Dict[str, Any]):
        self.initial = specs["initial"]
        self.interval = specs["interval"]
        self.factor = specs["factor"]

    def get_learning_rate(self, epoch: int) -> float:
        return self.initial * (self.factor ** (epoch // self.interval))


def optimizer_factory(
    config: Dict[str, Any], params: Iterable[torch.nn.Parameter]
) -> Tuple[StepLearningRateSchedule, torch.optim.Optimizer]:
    """(schedule, optimizer) from a training config: ``optimizer: Adam``
    (default; betas 0.9/0.999, eps 1e-8) or ``SGD`` with ``momentum``, the
    two the reference supports."""
    name = config.get("optimizer", "Adam")
    lr = config.get("lr", 1e-3)
    weight_decay = config.get("weight_decay", 0.0)
    schedule = StepLearningRateSchedule({
        "initial": lr, "interval": config.get("lr_step", 100),
        "factor": config.get("lr_decay", 0.1),
    })
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=config.get("momentum", 0.9),
                              weight_decay=weight_decay)
    else:
        raise NotImplementedError(f"unknown optimizer {name!r}")
    clip = config.get("clip_grad", 0.0)
    if clip:
        def clamp_gradients(optimizer, args, kwargs):
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.clamp_(-clip, clip)

        opt.register_step_pre_hook(clamp_gradients)
    return schedule, opt


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The epoch's rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
