"""Process groups for data-parallel training (the port's counterpart of
``nsdp_tpu/parallel/mesh.py``).

One process per device under ``torch.distributed``: the ranks come from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and each rank owns ``cuda:LOCAL_RANK``
(or runs on the CPU over gloo).  A step is the single-process step on the
whole batch: each rank runs the model on its own rows, BatchNorm statistics
are all-reduced (``nn.blocks.bn_sync``), and the loss and the gradients are
averaged (``training.steps.make_steps(group=...)``).

There is no ``Mesh``, and no counterpart of ``replicate``, ``shard_batch``
or ``globalize_batch``: the parameters live on each rank (broadcast once
from rank 0 after loading), and each rank uploads its own rows of every
batch (``parallel.multihost.process_batch_slice``).  Collectives are NCCL's
(or gloo's), outside the kernels; every rank launches the kernels on its
local rows.
"""

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from nsdp_tpu_torch import resolve_device


def _multiprocess_configured() -> bool:
    """True when the environment configures a launch of MORE THAN ONE
    process: torchrun's ``WORLD_SIZE``, or the SLURM / OpenMPI counts that
    ``nsdp_tpu/parallel/mesh.py:30-62`` reads.  A value that does not parse
    counts as configured, so that the process group's initialisation
    reports it."""
    env = os.environ.get
    for var in ("WORLD_SIZE", "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(env(var) or 1) > 1:
                return True
        except ValueError:
            if var == "WORLD_SIZE":
                return True
    return False


def world_size() -> int:
    """The number of ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_distributed(device="cuda") -> torch.device:
    """Join the process group that the environment configures, and pick
    this rank's device -> the device.

    Calls ``init_process_group`` (``env://``; ``nccl`` for a ``cuda``
    device, ``gloo`` for the CPU) only when the environment configures
    more than one process; without that it is a no-op.  A process group
    that already exists is used as it is, whatever its backend.  Any other
    failure propagates: a launch degraded silently into N independent
    single-process runs would have every rank believe it is rank 0 and
    write the shared experiment directory at once.

    ``device='cuda'`` under more than one rank means ``cuda:LOCAL_RANK``,
    made the current device before any CUDA tensor exists; a device with
    an index is taken as given.  With one process the device is
    ``resolve_device(device)``, as without this call.
    """
    dev = resolve_device(device)
    if not dist.is_initialized() and _multiprocess_configured():
        dev = _rank_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    elif world_size() > 1:
        dev = _rank_device(dev)
    return dev


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank())
    torch.cuda.set_device(dev)
    return dev


def check_train_batch(batch_size: int) -> None:
    """Every rank takes part in every step, so the world size must divide
    the batch (the counterpart of ``make_train_mesh``'s multi-host rule,
    ``nsdp_tpu/parallel/mesh.py:125-130``)."""
    n = world_size()
    if n > 1 and batch_size % n:
        raise ValueError(
            f"multi-process training ({n} processes, {n} devices) requires batch_size "
            f"divisible by the device count; got batch_size={batch_size}. Pick a multiple "
            f"of {n}."
        )


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum of the cotangents
    over the ranks (the transpose of a sum over ranks is itself).  Safe to
    capture in a CUDA graph (:func:`capturable`): a copy and a collective
    queued on the current stream, no host read of a device value."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of ``group``, differentiable:
    the backward all-reduces the cotangent, so every rank's gradient takes
    the terms of the other ranks' losses (a plain ``dist.all_reduce``
    would drop them without an error)."""
    return _AllReduceSum.apply(tensor, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group,
                    world: Optional[int] = None) -> List[torch.Tensor]:
    """Several tensors of one dtype and device summed over the ranks of
    ``group`` through ONE all-reduce of a flat buffer, then divided by
    ``world`` where it is given (the mean: the group's size, a Python
    number the caller reads before any capture) -> the results, shaped as
    given (views of the buffer).  Not differentiable.  Safe to capture
    (:func:`capturable`): the concatenation, the collective and the
    division are queued on the current stream; nothing reads the device."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if world is not None:
        flat /= world
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def capturable(group) -> bool:
    """Whether ``group``'s collectives can run inside a CUDA graph: NCCL's
    are kernels on a stream, which a capture records; gloo's run on the
    host, which a capture cannot hold."""
    return dist.get_backend(group) == dist.Backend.NCCL


def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` from rank 0, so that no
    rank starts apart."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t, 0)
