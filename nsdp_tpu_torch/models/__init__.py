"""Model construction (counterpart of ``nsdp_tpu/models/__init__.py``).

``build_model(config)`` dispatches on ``config['model']['type']`` like the
reference (``model/__init__.py:43-118``):

* ``forward``   -> DeformationNetwork(no_input_corr=False)
* ``backward``  -> DeformationNetwork(no_input_corr=True)
* ``arbitrary`` -> FlowArbitrary(backward net, forward net)

The encoder is ``pointransformer`` (shipped) or ``pointnet++`` (ablation),
the decoder ``crossatten`` (shipped) or ``interp`` (ablation), by
``encoder_dict`` / ``decoder_dict`` as in ``nsdp_tpu/models/__init__.py:79-100``.
The port has one path (every kNN attention through the fused kernel, the
semantics of the JAX package's ``fused_attention: true``), so
``fused_attention`` is not read.

``model.compute_dtype`` (``nsdp_tpu/models/__init__.py:110-122``) is the
activation dtype: ``float32`` or absent computes as before, ``bfloat16``,
``float16`` or another float name computes every layer the JAX package
builds with ``dtype=`` in that type, while parameters and BatchNorm
statistics stay float32 (``nn/blocks.py`` says where).  ``model.remat:
true`` recomputes each encoder and decoder call in the backward
(``torch.utils.checkpoint``, as ``nn.remat`` wraps them,
``nsdp_tpu/models/__init__.py:77-84``); see ``models/deformation.py``.
"""

from typing import Any, Dict, Optional

import numpy as np
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
    "compute_dtype",
    "evaluation_config",
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


def compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """``model.compute_dtype`` as a torch dtype, None for float32 (no cast
    anywhere: the float32 path is the one without the key).  Names are
    read as ``jnp.dtype`` reads them: an unknown name raises ``TypeError``;
    a name that is not a floating type raises ``ValueError``."""
    if name is None or name == "float32":
        return None
    if name != "bfloat16":
        name = np.dtype(name).name  # TypeError on a name numpy does not know
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"model.compute_dtype: {name!r} is not a floating type")
    return None if dtype == torch.float32 else dtype


def build_deformation_network(config: Dict[str, Any], no_input_corr: bool = False,
                              device=None) -> DeformationNetwork:
    """One encoder + decoder on ``device`` (``cuda`` unless told otherwise)."""
    device = resolve_device(device)
    model_cfg = config["model"]
    dtype = compute_dtype(model_cfg.get("compute_dtype"))
    has_features, inp_feat_dim = _feature_dims(model_cfg, no_input_corr)
    encoder = encoder_dict[model_cfg["encoder"]](
        **model_cfg["encoder_kwargs"], has_features=has_features,
        inp_feat_dim=inp_feat_dim, device=device, dtype=dtype,
    )
    decoder = decoder_dict[model_cfg["decoder"]](**model_cfg["decoder_kwargs"], device=device,
                                                 dtype=dtype)
    return DeformationNetwork(encoder, decoder, no_input_corr=no_input_corr,
                              use_normals=model_cfg.get("use_normals", False),
                              remat=bool(model_cfg.get("remat", False)))


def evaluation_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The config the evaluation entry points (``DeformationService``,
    ``test``, ``run``) build their model from.

    For the shipped pair (``pointransformer`` + ``crossatten``) the JAX
    package evaluates through ``make_fast_predict`` without a
    ``compute_dtype`` (``nsdp_tpu/serving.py:87``, ``test.py:95``,
    ``run.py:100``), which reads the raw parameters and runs float32
    whatever ``model.compute_dtype`` says: that pair's config loses the
    key here, so a bfloat16-trained model evaluates bit for bit as a
    float32 one.  The ablation pairs evaluate through the flax modules
    (``fast_predict_enabled``, ``nsdp_tpu/models/fast_predict.py:35-55``), in
    the config's dtype, and keep it.
    """
    model_cfg = config["model"]
    shipped = model_cfg["encoder"] == "pointransformer" and model_cfg["decoder"] == "crossatten"
    if not shipped or "compute_dtype" not in model_cfg:
        return config
    return {**config, "model": {k: v for k, v in model_cfg.items() if k != "compute_dtype"}}


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
def init_random(model: nn.Module, seed: int, out_scale: float = 1.0) -> nn.Module:
    """Seeded random weights and BatchNorm statistics, the same on any device.

    Linear weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2); BatchNorm scale
    ~ 1 + N(0, 0.1^2), shift ~ N(0, 0.1^2), running mean ~ N(0, 0.1^2),
    running variance ~ U(0.5, 1.5).  Drawn on the CPU from one
    ``torch.Generator`` in module order, then copied to the parameters'
    device.

    The statistics do not match the activations, so the deformed positions
    come out at O(100).  ``out_scale`` multiplies every decoder's output
    layer (``fc_out``) after the draws: 0.01 puts them near the unit scale
    of a trained model's, where the evaluation metrics' nearest-neighbour
    search costs what it costs on real predictions.
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
    if out_scale != 1.0:
        for m in model.modules():
            if isinstance(m, (CrossTransformerDecoder, PointInterpDecoder)):
                m.fc_out.weight.mul_(out_scale)
                m.fc_out.bias.mul_(out_scale)
    return model
