"""Host-side data pipeline (the port's own copy of ``nsdp_tpu/data``).

Dataset registry mirrors the reference (``dataset/__init__.py:5-10``):
``deform4d`` / ``deformtransfer`` / ``tosca`` / ``dogrec`` (the last two share
the user-handle dataset class).
"""

from nsdp_tpu_torch.data.datasets import (
    Deform4DFlowDataset,
    DeformTransferFlowDataset,
    DeformUserhandleDataset,
)
from nsdp_tpu_torch.data.loader import DataLoader, split_batch

dataset_dict = {
    "deform4d": Deform4DFlowDataset,
    "deformtransfer": DeformTransferFlowDataset,
    "tosca": DeformUserhandleDataset,
    "dogrec": DeformUserhandleDataset,
}

__all__ = [
    "dataset_dict",
    "Deform4DFlowDataset",
    "DeformTransferFlowDataset",
    "DeformUserhandleDataset",
    "DataLoader",
    "split_batch",
]
