"""PyTorch/CUDA port of NSDP for NVIDIA Hopper (H100).

A second package beside the JAX/TPU one (``nsdp_tpu``), which stays the
numerical reference.  Plain tensor code is PyTorch; every TPU kernel of the
JAX package is a hand-written CUDA kernel under ``csrc/``:

* fused kNN vector attention, forward (``ops/attention.py`` +
  ``csrc/attention.cu``) and backward (``csrc/attention_bwd.cu``),
* furthest-point sampling (``ops/fps.py`` + ``csrc/fps.cu``),
* k nearest points (``ops/knn.py`` + ``csrc/knn.cu``),
* the row gather of the PointNet++ grouping (``ops/gather.py`` +
  ``csrc/gather.cu``).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain PyTorch
version; with no card and no explicit CPU request they raise.
"""

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and no card is visible -- the port never carries on silently
    on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nsdp_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
