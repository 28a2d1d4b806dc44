"""Checkpoints with the reference's on-disk contract (counterpart of
``nsdp_tpu/training/checkpoints.py``; reference ``utils/checkpoints.py``).

* ``model_{epoch:05d}`` / ``opt_{epoch:05d}`` every save;
* ``modelbest_{epoch:05d}_{loss:03f}`` for the best validation loss;
* resume takes the highest epoch in the directory.

Model files are the reference's torch format,
``{"epoch": int, "model_state_dict": state_dict}``, with the reference's key
names, so the JAX package's ``load_model_variables`` reads them and the
port reads the published ``forward.pt`` / ``backward.pt`` / ``arbitrary.pt``
(raw state dicts are accepted too).  Optimizer files hold
``{"epoch", "optimizer_state_dict"}``.

:func:`read_state_dict` also reads the JAX package's model files (flax
msgpack of ``{"params", "batch_stats"}``,
``nsdp_tpu/training/checkpoints.py:29-42``), so every path that loads
weights takes a model trained by either package, and
:func:`read_optimizer_state` its optimizer files (flax msgpack of the optax
state, ``:36-42``), so ``python -m nsdp_tpu_torch.train`` resumes a run that
``python train.py`` started with its Adam moments or SGD momentum
(:func:`optimizer_state_from_jax`).
"""

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from nsdp_tpu_torch.utils.convert import from_jax_variables
from nsdp_tpu_torch.utils.msgpack_reader import (
    is_msgpack_map,
    read_flax_optimizer,
    read_flax_variables,
)

_MODEL_RE = re.compile(r"^model_(\d{5})$")
_BEST_RE = re.compile(r"^modelbest_(\d{5})_([\d.]+)$")


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a model file, on the CPU.

    The format is decided by the file's first byte: a non-empty msgpack
    map is a JAX package model file, mapped through
    :func:`nsdp_tpu_torch.utils.convert.from_jax_variables`; anything else
    goes to ``torch.load`` (a zip, ``PK``, or a legacy pickle, ``0x80 0x02``),
    a raw state dict or ``{"model_state_dict": ...}``.
    """
    if _is_flax_file(path):
        return from_jax_variables(*read_flax_variables(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return obj


def _is_flax_file(path: str) -> bool:
    with open(path, "rb") as f:
        return is_msgpack_map(f.read(1))


def optimizer_state_from_jax(opt_state: dict, model: nn.Module,
                             optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The torch ``optimizer.state_dict()`` holding an optax state as the
    JAX package's ``optimizer_factory`` builds it (``nsdp_tpu/training/
    optim.py``: ``clip`` and ``add_decayed_weights`` stages, stateless, then
    ``scale_by_adam`` or ``trace``).

    The moments have the params tree's structure and map onto
    ``model.named_parameters()`` by the key rules of
    :func:`~nsdp_tpu_torch.utils.convert.from_jax_variables` (Dense kernels
    transposed): Adam's ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``,
    ``count`` -> every parameter's ``step`` (float32, as torch keeps it);
    SGD's ``trace`` -> ``momentum_buffer``.  The parameter groups are the
    optimizer's own (the JAX package keeps the rate outside its state)."""
    stages = [opt_state[k] for k in sorted(opt_state, key=int)]
    stateful = [st for st in stages if st]
    if len(stateful) != 1:
        raise ValueError(f"optax state with {len(stateful)} stateful stages; expected one")
    (stage,) = stateful
    if isinstance(optimizer, torch.optim.Adam) and set(stage) == {"count", "mu", "nu"}:
        moments = {"exp_avg": stage["mu"], "exp_avg_sq": stage["nu"]}
        step = torch.tensor(float(stage["count"]), dtype=torch.float32)
    elif isinstance(optimizer, torch.optim.SGD) and set(stage) == {"trace"}:
        moments, step = {"momentum_buffer": stage["trace"]}, None
    else:
        raise ValueError(f"optax state {sorted(stage)} does not fit {type(optimizer).__name__}")
    names = {id(p): name for name, p in model.named_parameters()}
    order = [names[id(p)] for group in optimizer.param_groups for p in group["params"]]
    mapped = {key: from_jax_variables(tree, {}) for key, tree in moments.items()}
    for key, values in mapped.items():
        missing = set(order) - set(values)
        if missing:
            raise ValueError(f"optax {key} has no moment for {sorted(missing)[:3]}")
    state = {}
    for i, name in enumerate(order):
        state[i] = {key: values[name] for key, values in mapped.items()}
        if step is not None:
            state[i]["step"] = step.clone()
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def read_optimizer_state(path: str, model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The optimizer state dict of an ``opt_*`` file, decided by its first
    byte as :func:`read_state_dict` decides: a JAX package file
    (:func:`optimizer_state_from_jax`), else the port's torch file."""
    if _is_flax_file(path):
        return optimizer_state_from_jax(read_flax_optimizer(path)[0], model, optimizer)
    return torch.load(path, map_location="cpu", weights_only=True)["optimizer_state_dict"]


def _write_model(path: str, epoch: int, state: Dict[str, torch.Tensor]) -> None:
    state = {k: v.detach().cpu() for k, v in state.items()}
    torch.save({"epoch": epoch, "model_state_dict": state}, path)


def write_checkpoints(epoch: int, model_state: Dict[str, torch.Tensor],
                      optimizer_state: Dict[str, Any], experiment_directory: str) -> None:
    """Write ``model_{epoch:05d}`` and ``opt_{epoch:05d}`` from a model's and
    an optimizer's state dicts."""
    _write_model(os.path.join(experiment_directory, f"model_{epoch:05d}"), epoch, model_state)
    torch.save({"epoch": epoch, "optimizer_state_dict": optimizer_state},
               os.path.join(experiment_directory, f"opt_{epoch:05d}"))


def save_checkpoints(epoch: int, model: nn.Module, optimizer: torch.optim.Optimizer,
                     experiment_directory: str) -> None:
    """Write ``model_{epoch:05d}`` and ``opt_{epoch:05d}``."""
    write_checkpoints(epoch, model.state_dict(), optimizer.state_dict(), experiment_directory)


def load_checkpoints(model: nn.Module, optimizer: torch.optim.Optimizer,
                     experiment_directory: str) -> Optional[int]:
    """Resume from the latest ``model_*`` / ``opt_*`` pair, if any, written
    by either package: loads both in place and returns the epoch to continue
    from, else None."""
    if not os.path.isdir(experiment_directory):
        return None
    ids = [int(m.group(1)) for f in os.listdir(experiment_directory)
           if (m := _MODEL_RE.match(f))]
    if not ids:
        return None
    epoch = max(ids)
    model_path = os.path.join(experiment_directory, f"model_{epoch:05d}")
    opt_path = os.path.join(experiment_directory, f"opt_{epoch:05d}")
    if not os.path.exists(opt_path):
        return None
    print(f"Loading model checkpoint from {model_path}")
    model.load_state_dict(read_state_dict(model_path), strict=True)
    print(f"Loading optimizer checkpoint from {opt_path}")
    # load_state_dict moves the moments onto the parameters' device
    optimizer.load_state_dict(read_optimizer_state(opt_path, model, optimizer))
    return epoch + 1


def write_best_checkpoints(epoch: int, model_state: Dict[str, torch.Tensor],
                           experiment_directory: str, val_loss: float) -> None:
    """Write ``modelbest_{epoch:05d}_{val_loss:03f}`` from a model's state dict."""
    path = os.path.join(experiment_directory, f"modelbest_{epoch:05d}_{val_loss:03f}")
    _write_model(path, epoch, model_state)


def save_best_checkpoints(epoch: int, model: nn.Module, experiment_directory: str,
                          val_loss: float) -> None:
    """Write ``modelbest_{epoch:05d}_{val_loss:03f}``."""
    write_best_checkpoints(epoch, model.state_dict(), experiment_directory, val_loss)


def load_best_checkpoints(model: nn.Module, experiment_directory: str
                          ) -> Tuple[Optional[int], Optional[float]]:
    """Load the latest ``modelbest_*`` in place; -> (epoch to continue from,
    its validation loss), or (None, None)."""
    if not os.path.isdir(experiment_directory):
        return None, None
    entries = [(m.group(1), m.group(2)) for f in os.listdir(experiment_directory)
               if (m := _BEST_RE.match(f))]
    if not entries:
        return None, None
    epoch_s, loss_s = max(entries)
    path = os.path.join(experiment_directory, f"modelbest_{epoch_s}_{loss_s}")
    print(f"Loading model checkpoint from {path}")
    model.load_state_dict(read_state_dict(path), strict=True)
    return int(epoch_s) + 1, float(loss_s)
