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
"""

import os
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

_MODEL_RE = re.compile(r"^model_(\d{5})$")
_BEST_RE = re.compile(r"^modelbest_(\d{5})_([\d.]+)$")


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a model file, raw or ``{"model_state_dict": ...}``,
    on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return obj


def _save_model(path: str, epoch: int, model: nn.Module) -> None:
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": epoch, "model_state_dict": state}, path)


def save_checkpoints(epoch: int, model: nn.Module, optimizer: torch.optim.Optimizer,
                     experiment_directory: str) -> None:
    """Write ``model_{epoch:05d}`` and ``opt_{epoch:05d}``."""
    _save_model(os.path.join(experiment_directory, f"model_{epoch:05d}"), epoch, model)
    torch.save({"epoch": epoch, "optimizer_state_dict": optimizer.state_dict()},
               os.path.join(experiment_directory, f"opt_{epoch:05d}"))


def load_checkpoints(model: nn.Module, optimizer: torch.optim.Optimizer,
                     experiment_directory: str) -> Optional[int]:
    """Resume from the latest ``model_*`` / ``opt_*`` pair, if any: loads
    both in place and returns the epoch to continue from, else None."""
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
    opt = torch.load(opt_path, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(opt["optimizer_state_dict"])
    return epoch + 1


def save_best_checkpoints(epoch: int, model: nn.Module, experiment_directory: str,
                          val_loss: float) -> None:
    """Write ``modelbest_{epoch:05d}_{val_loss:03f}``."""
    path = os.path.join(experiment_directory, f"modelbest_{epoch:05d}_{val_loss:03f}")
    _save_model(path, epoch, model)


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
