"""NSDP's stage-1 forward net and its train step in plain float32 PyTorch.

The published forward net (github.com/tangjiapeng/NSDP:
``model/deformation_networks.py``, ``Deformation_Networks`` with
``no_input_corr=False``, as ``configs/deform4d/forward.yaml`` builds it)
encodes the 7-channel conditioning [source surface | target surface *
handle mask | handle mask] and decodes the source space samples into
their target positions; its train step (``train_on_batch_with_cano``,
``deformation_networks.py:63-77``, driven by ``train.py``) takes the l2
loss against ``space_samples_tgt`` and one Adam step.  FlowArbitrary's
``model_deform`` is this same net (stage 2 loads ``forward.pt`` into it),
so the step is composed from ``model.py``'s ``Reference`` on the
``model_deform.`` share of a flat dict of weights in the published
names: ``encode("model_deform", inputs, True)``, ``decode``, ``l2_loss``
and ``Adam``.  It imports nothing of the program under test.

Departures from the published code, besides ``model.py``'s own (kNN and
FPS ties, every neighbourhood materialised):

* the source pose is the generator's shape (``traffic/generate.py``), not
  a dataset's canonical frame, and the handle is the share of the surface
  nearest a random surface point, not the dataset's box-slab rule
  (``dataset/utils.py:56-62``);
* Adam runs at a learning rate given per step (forward.yaml's schedule
  first decays after 200 epochs); no validation, no checkpoint, no
  logging.

:func:`train_step_counts` counts one step's attention sites and matrix
products on the ``meta`` device, as ``counts.train_step`` does stage 2's.
"""

from typing import Dict, List

import torch

from nsdp_bench.reference.model import Reference, l2_loss, parameter_spec

NET = "model_deform"  # FlowArbitrary's forward net: the stage-1 net's weights
TRAINABLE = ("weight", "bias", "bn_weight", "bn_bias")


def trainable(model_cfg: Dict) -> List[str]:
    """The forward net's trainable leaves, in the published order, without
    the ``model_deform.`` prefix (the stage-1 checkpoint's names)."""
    prefix = NET + "."
    return [n[len(prefix):] for n, _, kind in parameter_spec(model_cfg)
            if n.startswith(prefix) and kind in TRAINABLE]


def predict(ref: Reference, points: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """The forward net's deformed ``points`` (B, Q, 3) for the (B, N, 7)
    conditioning ``inputs``."""
    return ref.decode(NET, points, ref.encode(NET, inputs, True))


def loss(ref: Reference, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stage-1 loss of one batch (``train_on_batch_with_cano``)."""
    return l2_loss(predict(ref, batch["space_samples_src"], batch["surface_samples_inputs"]),
                   batch["space_samples_tgt"])


def train_step_counts(model_cfg: Dict, B: int, n_surface: int, n_queries: int) -> Dict:
    """One stage-1 train step (forward, loss, backward): ``sites`` (its
    forward attention calls, each with a backward) and ``flops`` (matrix
    products of the forward and backward), on the ``meta`` device."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {name: torch.empty(shape, dtype=torch.long if kind == "count" else torch.float32,
                                device="meta")
              for name, shape, kind in parameter_spec(model_cfg)}
    ref = Reference(model_cfg, params).train()
    ref.record = True
    leaves = [params[f"{NET}.{n}"].requires_grad_() for n in trainable(model_cfg)]
    batch = {"space_samples_src": torch.empty((B, n_queries, 3), device="meta"),
             "space_samples_tgt": torch.empty((B, n_queries, 3), device="meta"),
             "surface_samples_inputs": torch.empty((B, n_surface, 7), device="meta")}
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(loss(ref, batch), leaves)
    return {"sites": list(ref.sites), "flops": float(counter.get_total_flops())}
