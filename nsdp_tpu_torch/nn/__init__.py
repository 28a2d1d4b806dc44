"""Point-transformer and PointNet++ building blocks, train and eval mode."""

from nsdp_tpu_torch.nn.blocks import (
    BatchNorm,
    CrossTransformerBlock,
    ElementwiseMLP,
    PointNetSetAbstraction,
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
    "PointNetSetAbstraction",
    "ResnetBlockFC",
    "TransformerBlock",
    "TransformerSetAbstraction",
    "TransitionDown",
    "TwoLayerMLP",
]
