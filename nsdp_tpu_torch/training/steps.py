"""Train / validate / predict steps on one device or data-parallel over
the ranks of a process group, and the test entry points' per-batch
evaluation (counterpart of ``nsdp_tpu/training/steps.py:28-374``; reference
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
On the card every program that the JAX package compiles runs as a
captured CUDA graph per input signature (``graphs.Graphs``, the
counterpart of ``jax.jit``): the train step's device work up to the
update -- forward, loss, backward, the BatchNorm snapshot, the stage-2
running-statistics update and, under an NCCL group, its all-reduces --
with the optimizer's update eagerly after it; validation, ``watch_stats``
and ``predict``.
"""

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from nsdp_tpu_torch import resolve_device
from nsdp_tpu_torch.graphs import Graphs
from nsdp_tpu_torch.nn.blocks import BatchNorm, Dense, bn_sync
from nsdp_tpu_torch.parallel.dist import all_reduce_flat, capturable
from nsdp_tpu_torch.training.optim import set_learning_rate
from nsdp_tpu_torch.utils.padding import predict_padded
from nsdp_tpu_torch.utils.profiling import span

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
               nan_guard: bool = False, device=None, group=None,
               graphs: Optional[bool] = None) -> Dict[str, Callable]:
    """The step functions of a model.

    Args:
      model: a ``DeformationNetwork`` ('forward' / 'backward') or
        ``FlowArbitrary`` ('arbitrary') on ``device``.
      model_type: 'forward' | 'backward' | 'arbitrary'.
      optimizer: from :func:`nsdp_tpu_torch.training.optim.optimizer_factory`.
      nan_guard: on a non-finite loss skip the update, and put back every
        BatchNorm's running statistics (the train-mode forward moved them
        in place), so parameters, optimizer state and statistics stay as
        they were; the loss is still returned (and ``.grad`` is None).
      device: where batches go (``cuda`` unless told otherwise), in the
        model's dtype.
      group: a ``torch.distributed`` process group whose ranks each hold
        their own rows of every batch (the counterpart of ``mesh=``,
        ``nsdp_tpu/training/steps.py:84-88,134-151,212-243``): the
        train-mode forward runs under synced BatchNorm
        (``nn.blocks.bn_sync``), the loss and the gradients are averaged
        over the ranks in one all-reduce of a flat buffer a step (unreached
        parameters' zero gradients included, so every rank reduces the same
        list), ``nan_guard`` decides on the averaged loss, ``validate_step``
        averages and ``validate_step_masked`` sums (numerator, count) over
        the ranks.  Every step but ``predict`` is then a collective that
        every rank must call.  The parameters must start equal on every
        rank (``parallel.broadcast_module``).  None: this process alone.
      graphs: run each step's device work as a captured CUDA graph per
        input signature (``graphs.Graphs``, the counterpart of the JAX
        steps' ``jax.jit``).  The train step's program is the train-mode
        forward and loss, the gradients (every parameter's, as
        ``full_grads`` makes them), the BatchNorm snapshot, the stage-2
        double update and, under a group, synced BatchNorm's and the flat
        gradient and loss all-reduces.  Its first call at a shape is a real
        step run eagerly on a side stream, the next captures and replays,
        later ones replay, so a captured run's trajectory is the eager
        run's step for step.  ``set_learning_rate`` and
        ``optimizer.step()`` stay eager, after the replay: the parameters
        are the eager step's bit for bit, a new learning rate needs no new
        capture, and the optimizer's state keeps its checkpoint format.
        ``.grad`` holds gradient buffers of the steps' own, outside the
        programs' memory pool, which each step writes (one multi-tensor
        copy inside the graph) and hands back to ``.grad`` after a
        ``nan_guard`` skip set it to None.  ``validate_step``,
        ``validate_step_masked``, ``watch_stats`` (the train-mode forward
        and backward, the BatchNorm buffers snapshotted and put back
        inside the graph) and ``predict`` run their first call of a
        signature eagerly and capture at the second, so a signature seen
        once (``run``'s per-mesh shapes, a short run's one validation
        batch) captures nothing and costs what an eager call costs.
        All five share one ``Graphs`` (one memory pool, so a program
        captured later reuses what an earlier capture freed): every output
        of theirs is read (a loss, the norms, ``nan_guard``'s snapshot),
        copied (``predict``'s, an unfetched loss) or held outside the pool
        (``.grad``) before the next call of any of them.  Under a group
        every rank makes the same calls at the same signatures, so the
        ranks capture at the same call and replay each collective
        together.  None (the default): on for a card, without a group or
        with an NCCL one; False: eager; True on the CPU keeps the
        static-buffer contract, for the tests (with a gloo group too).  A
        gloo group's collectives cannot be captured
        (``parallel.capturable``): on the card its steps stay eager and
        ``graphs=True`` raises ``ValueError``.

    Returns:
      ``train_step(batch, lr, fetch=True) -> loss``,
      ``validate_step(batch) -> loss``,
      ``validate_step_masked(batch, sample_mask) -> loss`` (mean over the
      rows with a nonzero ``sample_mask``),
      ``watch_stats(batch) -> (param_norms, grad_norms)`` and
      ``predict(points, surface_samples_inputs, point_mask=None) -> tensor``.
      Losses are Python floats, except ``train_step(..., fetch=False)``'s
      without ``nan_guard``: a 0-d tensor on ``device`` that the caller
      owns (a copy of a captured step's static loss), so that the host
      queues the step without waiting for the device.  ``train_step.graphs``
      is the :class:`~nsdp_tpu_torch.graphs.Graphs` of the captured steps,
      or None; the other four functions' ``.graphs`` is the same one.
      ``predict`` returns a tensor the caller owns.  Under a group every
      loss is the mean over the whole batch, and ``watch_stats`` reports
      the averaged gradients.
    """
    device = resolve_device(device)
    if group is not None and device.type == "cuda" and not capturable(group):
        if graphs:
            raise ValueError(f"a {dist.get_backend(group)} group's collectives cannot be captured "
                             "(an NCCL group's can): pass graphs=None or False")
        graphs = False
    if graphs is None:
        graphs = device.type == "cuda"
    captured = Graphs(device) if graphs else None  # every step's programs, one pool
    world = None if group is None else dist.get_world_size(group)  # read before any capture
    arbitrary = model_type == "arbitrary"
    all_bns = _batch_norms(model)
    cano_bns = _batch_norms(model.model_canonicalize.encoder) if arbitrary else []
    params = list(model.parameters())
    # the train step's span detail: the model type, then the compute dtype
    # where one is set (a float32 model's spans read as before)
    narrow = sorted({str(m.dtype).split(".")[-1] for m in model.modules()
                     if isinstance(m, (Dense, BatchNorm)) and m.dtype is not None})
    step_detail = " ".join([model_type, *narrow])
    # captured, the gradients live in buffers of their own, outside the
    # programs' pool: each train step writes them, so ``.grad`` outlives the
    # calls of every other program of the pool
    grad_bufs = [torch.zeros_like(p) for p in params] if captured is not None else None
    dtype = params[0].dtype
    # each top-level module with the positions of its parameters in ``params``
    position = {id(p): i for i, p in enumerate(params)}
    children = [(name, [position[id(p)] for p in child.parameters()])
                for name, child in model.named_children()]

    def tensor(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    def forward(points, surface_samples_inputs, point_mask=None):
        points, inputs = tensor(points), tensor(surface_samples_inputs)
        point_mask = tensor(point_mask)
        if arbitrary:
            return model(points, inputs[..., 0:3], inputs[..., 3:6], inputs[..., 6:7], point_mask)
        return model(points, inputs, point_mask)

    def step_inputs(batch: Dict[str, Any]):
        """(points, conditioning, targets, point mask or None) of a batch
        on ``device``, in the model's dtype."""
        return (tensor(batch["space_samples_src"]), tensor(batch["surface_samples_inputs"]),
                tensor(batch["space_samples_tgt"]), tensor(batch.get("surface_valid_mask")))

    def train_loss(points, inputs, target, point_mask) -> torch.Tensor:
        """The train-mode loss (running statistics updated in place; the
        stage-2 encoder's first update only)."""
        model.train()
        with bn_sync(group):
            pred = forward(points, inputs, point_mask)
        return compute_l2_error(pred, target)

    def full_grads(grads):
        """Every parameter's gradient: a parameter the loss does not reach
        (the interp decoder leaves the encoder's ``fc_middle`` unused)
        takes a zero gradient, as in the JAX package -- torch's optimizers
        would skip it, its weight decay and its Adam step count included."""
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def forward_backward(points, inputs, target, point_mask):
        """A train step's device work up to the update -> (loss, every
        parameter's gradient, the BatchNorm buffers before the forward
        that ``nan_guard`` restores); under a group the loss and the
        gradients averaged over the ranks.  The stage-2 encoder's second
        running-statistics update is made here: a non-finite loss restores
        every buffer from the snapshot, that update included."""
        saved_all = _snapshot(all_bns) if nan_guard else []
        saved_cano = _snapshot(cano_bns)
        loss = train_loss(points, inputs, target, point_mask)
        grads = full_grads(torch.autograd.grad(loss, params, allow_unused=True))
        _double_bn_update(cano_bns, saved_cano)
        loss = loss.detach()
        if group is not None:
            *grads, loss = all_reduce_flat([*grads, loss], group, world)
        if grad_bufs is not None:
            torch._foreach_copy_(grad_bufs, grads)
            grads = grad_bufs
        return loss, grads, saved_all

    def train_step(batch: Dict[str, Any], lr: float, fetch: bool = True):
        with span("train.step", step_detail):
            with span("train.inputs"):
                args = step_inputs(batch)
            if not model.training:  # as the eager forward leaves it (a replay sets no mode)
                model.train()
            if captured is None:
                loss, grads, saved_all = forward_backward(*args)
            else:
                loss, grads, saved_all = captured("train_step", forward_backward, *args,
                                                  eager_calls=1)
            for p, g in zip(params, grads):
                if p.grad is not g:
                    p.grad = g
            if nan_guard:  # the update depends on the loss: read it now
                with span("train.loss"):
                    value = float(loss)
                if not math.isfinite(value):
                    _restore(all_bns, saved_all)
                    optimizer.zero_grad(set_to_none=True)
                    return value
            with span("train.optimizer"):
                set_learning_rate(optimizer, lr)
                optimizer.step()
            if nan_guard:
                return value
            with span("train.loss"):
                if fetch:
                    return float(loss)
                # a captured step's loss is its program's output, which the
                # next step overwrites: the caller gets its own copy
                return loss if captured is None else loss.clone()

    train_step.graphs = captured

    def program(name, fn, *args, copy=False):
        """``fn(*args)``, through its captured program where the
        evaluation steps are captured: a signature's first call runs
        eagerly, its second captures (``eager_calls=1``)."""
        if captured is None:
            return fn(*args)
        return captured(name, fn, *args, eager_calls=1, copy=copy)

    def watch_norms(points, inputs, target, point_mask) -> torch.Tensor:
        """(2, parameters): each parameter's L2 norm and its gradient's
        (averaged over the ranks under a group) after one train-mode
        forward and backward, the BatchNorm buffers put back."""
        saved = _snapshot(all_bns)
        try:
            grads = torch.autograd.grad(train_loss(points, inputs, target, point_mask), params,
                                        allow_unused=True)
        finally:
            _restore(all_bns, saved)
        grads = full_grads(grads)
        if group is not None:
            grads = all_reduce_flat(grads, group, world)
        with torch.no_grad():
            return torch.stack([torch.stack([torch.linalg.vector_norm(t) for t in leaves])
                                for leaves in (params, grads)])

    def watch_stats(batch: Dict[str, Any]):
        """Parameter and gradient norms of one train-mode forward and
        backward on ``batch`` (``nsdp_tpu/training/steps.py:268-287``, the
        counterpart of the reference's ``wandb.watch``): ``((top-level
        module -> global L2 norm), per-parameter L2 norms)`` for the
        parameters and for the loss's gradients (no weight decay, no
        clipping; under a group the averaged gradients, and every rank
        must call it).  The top-level modules are the model's children, as
        the JAX variables' top-level keys are.  The model is left as it was:
        parameters, running statistics, train/eval mode (set here, since a
        replay sets none), ``.grad``; the optimizer is not touched."""
        was_training = model.training
        try:
            host = program("watch_stats", watch_norms, *step_inputs(batch)).cpu()
        finally:
            model.train(was_training)
        out = []
        for leaves in host:
            top = {name: float(torch.sqrt(torch.sum(leaves[idx] ** 2)))
                   for name, idx in children}
            out.append((top, leaves.numpy()))
        return tuple(out)

    def validation_loss(points, inputs, target, point_mask) -> torch.Tensor:
        loss = compute_l2_error(forward(points, inputs, point_mask), target)
        if group is not None:
            (loss,) = all_reduce_flat([loss], group, world)
        return loss

    @torch.no_grad()
    def validate_step(batch: Dict[str, Any]) -> float:
        model.eval()
        return float(program("validate_step", validation_loss, *step_inputs(batch)))

    def masked_validation_loss(points, inputs, target, point_mask, sample_mask) -> torch.Tensor:
        delta = forward(points, inputs, point_mask) - target
        per_sample = torch.mean(0.5 * torch.sum(delta * delta, dim=-1), dim=-1)
        num, den = torch.sum(per_sample * sample_mask), sample_mask.sum()
        if group is not None:
            num, den = all_reduce_flat([num, den], group)
        return num / torch.clamp(den, min=1.0)

    @torch.no_grad()
    def validate_step_masked(batch: Dict[str, Any], sample_mask) -> float:
        """Validation loss over real samples only: padded batch rows have a
        zero ``sample_mask`` (B,)."""
        model.eval()
        return float(program("validate_step_masked", masked_validation_loss,
                             *step_inputs(batch), tensor(sample_mask)))

    def prediction(points, inputs, point_mask) -> torch.Tensor:
        return forward(points, inputs, point_mask).float()

    @torch.no_grad()
    def predict(points, surface_samples_inputs, point_mask: Optional[Any] = None) -> torch.Tensor:
        """The deformation field at ``points`` (eval mode), in float32 (a
        model of a narrow ``compute_dtype`` returns its values widened),
        a tensor the caller owns: a captured program's output is
        overwritten by the next call of any of the four."""
        model.eval()
        return program("predict", prediction, tensor(points), tensor(surface_samples_inputs),
                       tensor(point_mask), copy=True)

    for fn in (watch_stats, validate_step, validate_step_masked, predict):
        fn.graphs = captured

    return {
        "train_step": train_step,
        "validate_step": validate_step,
        "validate_step_masked": validate_step_masked,
        "watch_stats": watch_stats,
        "predict": predict,
    }


def test_on_batch(steps: Dict[str, Callable], batch: Dict[str, Any],
                  compute_loss: bool = True, bucket: int = 4096):
    """The per-batch evaluation of the test and run entry points
    (counterpart of ``nsdp_tpu/training/steps.py:317-374``; reference
    ``test_on_batch_*``): deform the surface samples and the
    full-resolution vertices, stash both in ``batch`` as numpy
    (``surface_samples_tgt_pred``, ``verts_tgt_pred``), and optionally take
    the vertex loss.

    The queried source points are the surface samples, not space samples,
    for every model type (reference ``deformation_networks.py:91-109``,
    ``flow_arbitrary.py:66-85``).  Vertex queries are bucket-padded
    (:func:`nsdp_tpu_torch.utils.padding.predict_padded`); a padded partial
    batch's ``surface_valid_mask`` reaches both evaluations, and the loss is
    taken over ``verts_valid_mask`` where the batch has one.

    Returns ``(loss, batch)``; the loss is 0.0 without vertices or without
    ``compute_loss``.
    """
    inputs = batch["surface_samples_inputs"]
    point_mask = batch.get("surface_valid_mask")
    batch["surface_samples_tgt_pred"] = (
        steps["predict"](inputs[:, :, 0:3], inputs, point_mask).cpu().numpy()
    )
    if "verts_src" not in batch:
        return 0.0, batch
    batch["verts_tgt_pred"] = predict_padded(
        steps, batch["verts_src"], inputs, bucket, point_mask=point_mask
    )
    if not compute_loss or "verts_tgt" not in batch:
        return 0.0, batch
    pred = torch.as_tensor(batch["verts_tgt_pred"])
    tgt = torch.as_tensor(np.asarray(batch["verts_tgt"], np.float32))
    mask = batch.get("verts_valid_mask")
    if mask is None:
        return float(compute_l2_error(pred, tgt)), batch
    mask = torch.as_tensor(np.asarray(mask, np.float32))
    delta2 = 0.5 * torch.sum((pred - tgt) ** 2, dim=-1) * mask
    return float(torch.sum(delta2) / torch.clamp(torch.sum(mask), min=1.0)), batch
