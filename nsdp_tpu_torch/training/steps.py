"""Train / validate / predict steps on one device (counterpart of
``nsdp_tpu/training/steps.py:28-314``; reference
``model/deformation_networks.py:63-109``, ``model/flow_arbitrary.py:30-85``).

Batch dict contract (the keys the reference datasets emit; numpy arrays or
tensors):
  * ``surface_samples_inputs`` (B, N, 7): source xyz | target xyz * handle
    mask | handle mask;
  * ``space_samples_src`` / ``space_samples_tgt`` (B, Q, 3);
  * optional ``surface_valid_mask`` (B, N), nonzero = real surface point.

The model and the optimizer hold the state and are updated in place.  On
the card every kNN attention of a train step runs K1 forward and K2
backward, every FPS K3; nothing carries gradients through a selection.
"""

import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from nsdp_tpu_torch import resolve_device
from nsdp_tpu_torch.nn.blocks import BatchNorm
from nsdp_tpu_torch.training.optim import set_learning_rate

BN_DECAY = 0.9  # the running statistics' EMA decay, 1 - BatchNorm momentum


def compute_l2_error(points_pred: torch.Tensor, points_gt: torch.Tensor) -> torch.Tensor:
    """0.5 * mean squared deformation error (reference ``model/utils.py:8-11``)."""
    delta = points_pred - points_gt
    return torch.mean(0.5 * torch.sum(delta * delta, dim=-1))


def _batch_norms(module: nn.Module) -> List[BatchNorm]:
    return [m for m in module.modules() if isinstance(m, BatchNorm)]


def _snapshot(bns: List[BatchNorm]):
    return [(bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone())
            for bn in bns]


def _restore(bns: List[BatchNorm], saved) -> None:
    for bn, (mean, var, count) in zip(bns, saved):
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        bn.num_batches_tracked.copy_(count)


@torch.no_grad()
def _double_bn_update(bns: List[BatchNorm], saved) -> None:
    """Compound a second identical running-statistics update.

    The reference's stage-2 step calls ``model_canonicalize`` twice with the
    same conditioning (``model/flow_arbitrary.py:19-20``), so its encoder's
    running statistics take two EMA updates with the same batch statistic.
    The encode-once composition makes one, ``new = m*old + (1-m)*batch``;
    the second is ``m*new + (1-m)*batch = (1+m)*new - m*old``
    (``nsdp_tpu/training/steps.py:28-42``).  Gradients need no correction.
    """
    m = BN_DECAY
    for bn, (mean, var, _) in zip(bns, saved):
        bn.running_mean.copy_((1.0 + m) * bn.running_mean - m * mean)
        bn.running_var.copy_((1.0 + m) * bn.running_var - m * var)


def make_steps(model: nn.Module, model_type: str, optimizer: torch.optim.Optimizer,
               nan_guard: bool = False, device=None) -> Dict[str, Callable]:
    """The step functions of a model.

    Args:
      model: a ``DeformationNetwork`` ('forward' / 'backward') or
        ``FlowArbitrary`` ('arbitrary') on ``device``.
      model_type: 'forward' | 'backward' | 'arbitrary'.
      optimizer: from :func:`nsdp_tpu_torch.training.optim.optimizer_factory`.
      nan_guard: on a non-finite loss skip the update, and put back every
        BatchNorm's running statistics (the train-mode forward moved them
        in place), so parameters, optimizer state and statistics stay as
        they were; the loss is still returned.
      device: where batches go (``cuda`` unless told otherwise), in the
        model's dtype.

    Returns:
      ``train_step(batch, lr) -> loss``, ``validate_step(batch) -> loss``,
      ``validate_step_masked(batch, sample_mask) -> loss`` (mean over the
      rows with a nonzero ``sample_mask``) and
      ``predict(points, surface_samples_inputs, point_mask=None) -> tensor``.
      Losses are Python floats.
    """
    device = resolve_device(device)
    arbitrary = model_type == "arbitrary"
    all_bns = _batch_norms(model)
    cano_bns = _batch_norms(model.model_canonicalize.encoder) if arbitrary else []
    params = list(model.parameters())
    dtype = params[0].dtype

    def tensor(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    def forward(points, surface_samples_inputs, point_mask=None):
        points, inputs = tensor(points), tensor(surface_samples_inputs)
        point_mask = tensor(point_mask)
        if arbitrary:
            return model(points, inputs[..., 0:3], inputs[..., 3:6], inputs[..., 6:7], point_mask)
        return model(points, inputs, point_mask)

    def train_step(batch: Dict[str, Any], lr: float) -> float:
        model.train()
        saved_all = _snapshot(all_bns) if nan_guard else None
        saved_cano = _snapshot(cano_bns)
        optimizer.zero_grad(set_to_none=True)
        pred = forward(batch["space_samples_src"], batch["surface_samples_inputs"],
                       batch.get("surface_valid_mask"))
        loss = compute_l2_error(pred, tensor(batch["space_samples_tgt"]))
        loss.backward()
        value = float(loss.detach())
        if nan_guard and not math.isfinite(value):
            _restore(all_bns, saved_all)
            optimizer.zero_grad(set_to_none=True)
            return value
        _double_bn_update(cano_bns, saved_cano)
        for p in params:
            # a parameter the loss does not reach (the interp decoder leaves
            # the encoder's ``fc_middle`` unused) takes a zero gradient, as
            # in the JAX package: torch's optimizers would skip it, its
            # weight decay and its Adam step count included
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        set_learning_rate(optimizer, lr)
        optimizer.step()
        return value

    @torch.no_grad()
    def validate_step(batch: Dict[str, Any]) -> float:
        model.eval()
        pred = forward(batch["space_samples_src"], batch["surface_samples_inputs"],
                       batch.get("surface_valid_mask"))
        return float(compute_l2_error(pred, tensor(batch["space_samples_tgt"])))

    @torch.no_grad()
    def validate_step_masked(batch: Dict[str, Any], sample_mask) -> float:
        """Validation loss over real samples only: padded batch rows have a
        zero ``sample_mask`` (B,)."""
        model.eval()
        pred = forward(batch["space_samples_src"], batch["surface_samples_inputs"],
                       batch.get("surface_valid_mask"))
        delta = pred - tensor(batch["space_samples_tgt"])
        per_sample = torch.mean(0.5 * torch.sum(delta * delta, dim=-1), dim=-1)
        sample_mask = tensor(sample_mask)
        return float(torch.sum(per_sample * sample_mask) / torch.clamp(sample_mask.sum(), min=1.0))

    @torch.no_grad()
    def predict(points, surface_samples_inputs, point_mask: Optional[Any] = None) -> torch.Tensor:
        """The deformation field at ``points`` (eval mode)."""
        model.eval()
        return forward(points, surface_samples_inputs, point_mask)

    return {
        "train_step": train_step,
        "validate_step": validate_step,
        "validate_step_masked": validate_step_masked,
        "predict": predict,
    }
