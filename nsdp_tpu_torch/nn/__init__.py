"""Eval-mode point-transformer building blocks."""

from nsdp_tpu_torch.nn.blocks import (
    BatchNorm,
    CrossTransformerBlock,
    ElementwiseMLP,
    ResnetBlockFC,
    TransformerBlock,
    TransformerSetAbstraction,
    TransitionDown,
    TwoLayerMLP,
)

__all__ = [
    "BatchNorm",
    "CrossTransformerBlock",
    "ElementwiseMLP",
    "ResnetBlockFC",
    "TransformerBlock",
    "TransformerSetAbstraction",
    "TransitionDown",
    "TwoLayerMLP",
]
