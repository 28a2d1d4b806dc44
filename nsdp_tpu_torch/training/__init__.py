"""Training: optimizers, step functions, checkpoints, partial loads
(counterpart of ``nsdp_tpu/training``, one device)."""

from nsdp_tpu_torch.training.checkpoints import (
    load_best_checkpoints,
    load_checkpoints,
    read_state_dict,
    save_best_checkpoints,
    save_checkpoints,
)
from nsdp_tpu_torch.training.optim import StepLearningRateSchedule, optimizer_factory
from nsdp_tpu_torch.training.partial_load import load_subnetwork
from nsdp_tpu_torch.training.steps import compute_l2_error, make_steps

__all__ = [
    "StepLearningRateSchedule",
    "compute_l2_error",
    "load_best_checkpoints",
    "load_checkpoints",
    "load_subnetwork",
    "make_steps",
    "optimizer_factory",
    "read_state_dict",
    "save_best_checkpoints",
    "save_checkpoints",
]
