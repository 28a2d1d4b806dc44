"""Data-parallel training over several processes and query-split serving
(the port's counterpart of ``nsdp_tpu/parallel``).

* :mod:`~nsdp_tpu_torch.parallel.dist`: the process group (one process per
  device under ``torch.distributed``), the rank's device, the batch rule,
  the all-reduces of the train step and of synced BatchNorm, and whether
  a group's collectives can be captured in a CUDA graph;
* :mod:`~nsdp_tpu_torch.parallel.multihost`: per-rank loader slices.

Serving splits the query axis over several devices of one process
(``serving.DeformationService(devices=...)``).
"""

from nsdp_tpu_torch.parallel.dist import (
    all_reduce_flat,
    all_reduce_sum,
    broadcast_module,
    capturable,
    check_train_batch,
    initialize_distributed,
    local_rank,
    rank,
    world_size,
)
from nsdp_tpu_torch.parallel.multihost import is_main_process, local_slice, process_batch_slice

__all__ = [
    "all_reduce_flat",
    "all_reduce_sum",
    "broadcast_module",
    "capturable",
    "check_train_batch",
    "initialize_distributed",
    "is_main_process",
    "local_rank",
    "local_slice",
    "process_batch_slice",
    "rank",
    "world_size",
]
