"""Per-rank input feeding (the port's counterpart of
``nsdp_tpu/parallel/multihost.py``; host-side, numpy).

Every rank draws the same shuffled order of the global batch and assembles
only its own contiguous rows of it (``DataLoader(batch_slice=...)``);
batches built whole on every rank (the padded validation batches) are cut
down with :func:`local_slice`.  There is no ``globalize_batch``: each rank
uploads its own rows.
"""

from typing import Any, Dict

from nsdp_tpu_torch.parallel.dist import rank, world_size


def process_batch_slice(global_batch_size: int) -> slice:
    """The [start, stop) rows of the global batch that this rank owns."""
    n = world_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    per = global_batch_size // n
    start = rank() * per
    return slice(start, start + per)


def local_slice(batch: Dict[str, Any], global_batch_size: int) -> Dict[str, Any]:
    """A batch assembled whole on every rank, cut down to this rank's rows
    (every value with a leading axis; the identity with one rank)."""
    sl = process_batch_slice(global_batch_size)
    return {k: v[sl] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


def is_main_process() -> bool:
    """True on the rank that writes the run's files (rank 0)."""
    return rank() == 0
