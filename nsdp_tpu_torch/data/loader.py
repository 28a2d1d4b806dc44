"""Batching data loader with bounded background prefetch.

The port's own copy of ``nsdp_tpu/data/loader.py``, its per-rank
``batch_slice`` included.  It replaces torch's ``DataLoader`` (reference
``train.py:121-136``) with a prefetching host pipeline: item assembly (numpy,
disk IO, KD-tree transforms) runs in a worker pool while the card computes.
Batches are numpy dicts; moving them to the device is the caller's (the step
functions of ``training/steps.py`` do it).

Memory contract: at most ``prefetch + num_workers`` batches are ever in
flight or assembled-but-unconsumed, regardless of how slowly the consumer
drains — batches are submitted through a sliding window, not all up front, so
epoch length never affects host RAM.

Workers default to threads (fine for IO-bound npz loading); pass
``worker_type='process'`` for GIL-heavy item assembly (KD-tree hole cutting,
partial-shape transforms — the work the reference ran in torch's process
workers).  Process workers use the ``spawn`` start method (never fork a
process holding a CUDA context) and ship the dataset to each worker once via
the pool initializer, not per task.
"""

from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import multiprocessing as mp

import numpy as np

# Per-process globals for process workers: the dataset/collate pair is sent
# once at pool start (initializer) instead of being pickled with every task.
_WORKER_DATASET = None
_WORKER_COLLATE = None


def _init_process_worker(dataset, collate):
    global _WORKER_DATASET, _WORKER_COLLATE
    _WORKER_DATASET = dataset
    _WORKER_COLLATE = collate


def _process_make_batch(idxs):
    return _WORKER_COLLATE([_WORKER_DATASET[int(i)] for i in idxs])


class DataLoader:
    """Iterates batches of collated samples.

    Args:
      dataset: indexable with ``__len__``, ``__getitem__`` and ``collate_fn``.
      batch_size: samples per batch.
      shuffle: reshuffle indices each epoch (numpy RandomState ``seed``).
      drop_last: drop the trailing partial batch (recommended for training;
        validation pads instead, see ``utils.padding.pad_batch``).
      num_workers: workers for item assembly (0 = synchronous).
      prefetch: extra ready batches held ahead of consumption; total
        in-flight + unconsumed work is bounded by ``prefetch + num_workers``.
      worker_type: 'thread' (default) or 'process' (GIL-heavy transforms;
        dataset and collate_fn must be picklable).
      batch_slice: optional slice of each batch's index list that this
        loader assembles (data-parallel training: every rank draws the SAME
        index order from the same ``seed`` and assembles only its
        ``parallel.multihost.process_batch_slice``).  Requires
        ``drop_last`` (a trailing partial batch would slice raggedly across
        ranks).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        prefetch: int = 2,
        seed: Optional[int] = None,
        collate_fn: Optional[Callable] = None,
        worker_type: str = "thread",
        batch_slice: Optional[slice] = None,
    ):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r}")
        if batch_slice is not None and not drop_last:
            raise ValueError("batch_slice requires drop_last=True")
        self.batch_slice = batch_slice
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.rng = np.random.RandomState(seed)
        self.collate = collate_fn or dataset.collate_fn
        self.worker_type = worker_type

    def _batch_indices(self):
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        end = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idxs = order[start : start + self.batch_size]
            yield idxs if self.batch_slice is None else idxs[self.batch_slice]

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _make_batch(self, idxs):
        return self.collate([self.dataset[int(i)] for i in idxs])

    def _make_pool(self):
        if self.worker_type == "process":
            return ProcessPoolExecutor(
                self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_init_process_worker,
                initargs=(self.dataset, self.collate),
            )
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            for idxs in self._batch_indices():
                yield self._make_batch(idxs)
            return

        submit_fn = (
            _process_make_batch
            if self.worker_type == "process"
            else self._make_batch
        )
        window = self.prefetch + self.num_workers
        pending: deque = deque()
        pool = self._make_pool()
        try:
            indices = self._batch_indices()
            for idxs in indices:
                pending.append(pool.submit(submit_fn, idxs))
                if len(pending) >= window:
                    break
            while pending:
                batch = pending.popleft().result()
                # refill the window BEFORE yielding so workers stay busy
                # while the consumer processes this batch
                nxt = next(indices, None)
                if nxt is not None:
                    pending.append(pool.submit(submit_fn, nxt))
                yield batch
        finally:
            for fut in pending:
                fut.cancel()
            pool.shutdown(wait=False, cancel_futures=True)


def split_batch(batch, batch_size=None, passthrough=()):
    """Per-sample views of a collated batch dict, keeping the batch dim.

    The reference evaluates at batch_size 1 (``test.py:81-87``); the CLIs
    evaluate whole batches on the device and then split the host-side batch
    back into per-sample dicts for the (host) metrics and mesh/pointcloud
    writers, which operate on one pair at a time.

    Contract: ``collate_fn`` stacks EVERY key along a new batch axis, and
    ``test_on_batch`` only adds batched prediction arrays — so every array
    value here must carry the batch axis.  A value that doesn't (wrong
    leading dim) raises instead of being silently passed through whole or
    sliced per sample; genuinely unbatched metadata must be named in
    ``passthrough``.
    """
    if batch_size is None:
        batch_size = int(np.asarray(batch["surface_samples_inputs"]).shape[0])
    for k, v in batch.items():
        if k in passthrough or not hasattr(v, "ndim"):
            continue
        if v.ndim < 1 or v.shape[0] != batch_size:
            raise ValueError(
                f"split_batch: {k!r} has shape {getattr(v, 'shape', None)} — "
                f"expected leading batch axis {batch_size}; pass it in "
                f"`passthrough` if it is genuinely unbatched"
            )
    for i in range(batch_size):
        yield {
            k: v
            if (k in passthrough or not hasattr(v, "ndim"))
            else v[i : i + 1]
            for k, v in batch.items()
        }
