"""Model construction (counterpart of ``nsdp_tpu/models/__init__.py``).

``build_model(config)`` dispatches on ``config['model']['type']`` like the
reference (``model/__init__.py:43-118``):

* ``forward``   -> DeformationNetwork(no_input_corr=False)
* ``backward``  -> DeformationNetwork(no_input_corr=True)
* ``arbitrary`` -> FlowArbitrary(backward net, forward net)

The encoder is ``pointransformer`` (shipped) or ``pointnet++`` (ablation),
the decoder ``crossatten`` (shipped) or ``interp`` (ablation), by
``encoder_dict`` / ``decoder_dict`` as in ``nsdp_tpu/models/__init__.py:79-100``.
The port has one path (every kNN attention through the fused kernel), so
``fused_attention`` is not read.
"""

from typing import Any, Dict

import torch
from torch import nn

from nsdp_tpu_torch import resolve_device
from nsdp_tpu_torch.models.decoders import (
    CrossTransformerDecoder,
    PointInterpDecoder,
    decoder_dict,
)
from nsdp_tpu_torch.models.deformation import DeformationNetwork, FlowArbitrary
from nsdp_tpu_torch.models.encoders import (
    PointNetPlusPlusEncoder,
    PointTransformerEncoder,
    encoder_dict,
)
from nsdp_tpu_torch.nn.blocks import BatchNorm

__all__ = [
    "build_model",
    "build_deformation_network",
    "init_random",
    "CrossTransformerDecoder",
    "DeformationNetwork",
    "FlowArbitrary",
    "PointInterpDecoder",
    "PointNetPlusPlusEncoder",
    "PointTransformerEncoder",
    "decoder_dict",
    "encoder_dict",
]


def _feature_dims(model_cfg: Dict[str, Any], no_input_corr: bool):
    """Encoder feature configuration (reference ``deformation_networks.py:16-30``)."""
    use_normals = model_cfg.get("use_normals", False)
    if no_input_corr:
        return (True, 3) if use_normals else (False, 0)
    return True, (7 if use_normals else 4)


def build_deformation_network(config: Dict[str, Any], no_input_corr: bool = False,
                              device=None) -> DeformationNetwork:
    """One encoder + decoder on ``device`` (``cuda`` unless told otherwise)."""
    device = resolve_device(device)
    model_cfg = config["model"]
    has_features, inp_feat_dim = _feature_dims(model_cfg, no_input_corr)
    encoder = encoder_dict[model_cfg["encoder"]](
        **model_cfg["encoder_kwargs"], has_features=has_features,
        inp_feat_dim=inp_feat_dim, device=device,
    )
    decoder = decoder_dict[model_cfg["decoder"]](**model_cfg["decoder_kwargs"], device=device)
    return DeformationNetwork(encoder, decoder, no_input_corr=no_input_corr,
                              use_normals=model_cfg.get("use_normals", False))


def build_model(config: Dict[str, Any], device=None) -> nn.Module:
    """The model for ``config['model']['type']`` on ``device`` (``cuda``
    unless told otherwise; raises with no card), in eval mode;
    ``model.train()`` selects train mode (batch statistics in every
    BatchNorm), as the training steps do."""
    device = resolve_device(device)
    model_type = config["model"]["type"]
    if model_type == "forward":
        net = build_deformation_network(config, False, device)
    elif model_type == "backward":
        net = build_deformation_network(config, True, device)
    elif model_type == "arbitrary":
        if config["model"].get("use_normals", False):
            raise ValueError(
                "use_normals is not supported for the 'arbitrary' composition "
                "(the canonicalised surface has no normals)"
            )
        net = FlowArbitrary(build_deformation_network(config, True, device),
                            build_deformation_network(config, False, device))
    else:
        raise NotImplementedError(f"unknown model type {model_type!r}")
    return net.eval()


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights and BatchNorm statistics, the same on any device.

    Linear weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2); BatchNorm scale
    ~ 1 + N(0, 0.1^2), shift ~ N(0, 0.1^2), running mean ~ N(0, 0.1^2),
    running variance ~ U(0.5, 1.5).  Drawn on the CPU from one
    ``torch.Generator`` in module order, then copied to the parameters'
    device.
    """
    gen = torch.Generator().manual_seed(seed)

    def fill(t, draw):
        t.copy_(draw(t.shape))

    normal = lambda shape: torch.randn(shape, generator=gen)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
            fill(m.weight, lambda s: normal(s) / fan_in ** 0.5)
            if m.bias is not None:
                fill(m.bias, lambda s: 0.1 * normal(s))
        elif isinstance(m, BatchNorm):
            fill(m.weight, lambda s: 1.0 + 0.1 * normal(s))
            fill(m.bias, lambda s: 0.1 * normal(s))
            fill(m.running_mean, lambda s: 0.1 * normal(s))
            fill(m.running_var, lambda s: 0.5 + torch.rand(s, generator=gen))
    return model
