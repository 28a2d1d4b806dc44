"""Checkpoint writes off the training thread (the port's counterpart of
``nsdp_tpu/training/async_ckpt.py``).

``AsyncCheckpointer`` copies the model's and the optimizer's state to host
memory on the calling thread, then serialises and writes them on a
background thread, so training does not wait on the disk.  The files are
those of :mod:`nsdp_tpu_torch.training.checkpoints` (``model_*``,
``opt_*``, ``modelbest_*``).

The copy is a real one on every device: on the CPU ``Tensor.cpu()``
returns the same storage, and ``optimizer.state_dict()`` holds the live
``exp_avg``/``exp_avg_sq`` tensors, which the next step updates in place
while the writer may still be reading them.
"""

import threading
from typing import Any, Optional

import torch
from torch import nn

from nsdp_tpu_torch.training import checkpoints as ckpt


def host_copy(obj: Any) -> Any:
    """``obj`` (nested dicts, lists and tuples of tensors and plain values)
    with every tensor copied to host memory of its own."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Writes checkpoints on a background thread, one save in flight at a
    time; a failed write is raised by the next :meth:`wait` or save."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        """Block until the save in flight (if any) is written; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _start(self, write, *args) -> None:
        def work():
            try:
                write(*args)
            except BaseException as e:  # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, epoch: int, model: nn.Module, optimizer: torch.optim.Optimizer,
             experiment_directory: str) -> None:
        """Snapshot the model and the optimizer, write ``model_*`` /
        ``opt_*`` in the background."""
        self.wait()
        self._start(ckpt.write_checkpoints, epoch, host_copy(model.state_dict()),
                    host_copy(optimizer.state_dict()), experiment_directory)

    def save_best(self, epoch: int, model: nn.Module, experiment_directory: str,
                  val_loss: float) -> None:
        """Snapshot the model, write ``modelbest_*`` in the background."""
        self.wait()
        self._start(ckpt.write_best_checkpoints, epoch, host_copy(model.state_dict()),
                    experiment_directory, val_loss)
