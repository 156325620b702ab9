"""Prefetching data loader (threads or worker processes).

Counterpart of ``simple_hrnet_tpu/data/loader.py``, the analogue of the
reference's ``DataLoader(num_workers=4)`` (Train.py:212-218): workers run
the cv2-heavy ``__getitem__`` while the device computes, and an ordered,
bounded prefetch queue keeps batches ready ahead of the train step.
Threads are the default (imread/warpAffine release the GIL);
``use_processes=True`` switches to a process pool. The shuffled order is
the JAX package's (``np.random.default_rng(seed + epoch)``), so that an
epoch of either package sees the same batches; ``torch.utils.data``'s
samplers draw another order.

``shard=(rank, count)`` (data-parallel training, one process a device)
gives each of ``count`` processes its equal, disjoint rows of every global
batch of ``batch_size`` rows, in the same shuffled global order: process
``rank`` takes the ``rank``-th part. A short last batch (no
``drop_last``) is padded to a multiple of ``count`` by repeating its last
row; ``batch_rows(step)`` is the global batch's real row count. The
augmentations are drawn in each process, so two processes see the global
batch of one process where the items draw nothing at random (evaluation,
or ``is_train=False``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Sequence

import numpy as np


def default_collate(items: Sequence[Any]):
    """Stack a list of per-sample outputs into batch arrays.

    Tuples/lists are collated per position; dicts per key; numeric
    values/arrays are stacked; strings and other objects become lists.
    """
    first = items[0]
    if isinstance(first, tuple):
        return tuple(default_collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(items)
    return list(items)


class DataLoader:
    """Iterate a map-style dataset in shuffled, prefetched batches."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 seed: int = 0, prefetch_batches: int = 3,
                 collate_fn=default_collate, use_processes: bool = False,
                 shard=None):
        self.use_processes = use_processes
        self.shard = shard
        if shard is not None and drop_last and batch_size % shard[1]:
            raise ValueError(f'batch_size={batch_size} does not divide over '
                             f'{shard[1]} processes')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        # floor of 1: queue.Queue(maxsize=0) means UNBOUNDED — a user's
        # "no prefetch" would let the producer materialize the whole epoch
        self.prefetch_batches = max(1, prefetch_batches)
        self.collate_fn = collate_fn
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Shuffle the next iteration as epoch ``epoch`` (seed + epoch), as
        a run that iterated ``epoch`` times before would."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_rows(self, step: int) -> int:
        """The real (unpadded) rows of global batch ``step``."""
        return min(self.batch_size, len(self.dataset) - step * self.batch_size)

    def _shard(self, idx: np.ndarray) -> np.ndarray:
        rank, count = self.shard
        pad = (-len(idx)) % count
        if pad:
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        k = len(idx) // count
        return idx[rank * k:(rank + 1) * k]

    def __iter__(self) -> Iterator[Any]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        batches: List[np.ndarray] = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            batches.append(idx if self.shard is None else self._shard(idx))

        out_q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def safe_put(item) -> bool:
            # timed put re-checking stop: a consumer that abandons iteration
            # early must not leave the producer blocked forever on a full
            # queue (leaking the thread + its pool per abandoned epoch)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if self.use_processes:
                    # the reference's num_workers subprocess model
                    # (Train.py:212-218); the dataset ships to each worker
                    # once via the pool initializer
                    from concurrent.futures import ProcessPoolExecutor
                    pool_cm = ProcessPoolExecutor(
                        self.num_workers, initializer=_init_worker,
                        initargs=(self.dataset,))
                    fetch = _worker_fetch
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    pool_cm = ThreadPoolExecutor(self.num_workers)
                    fetch = self.dataset.__getitem__
                with pool_cm as pool:
                    for bidx in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(fetch, bidx))
                        if not safe_put(('ok', self.collate_fn(items))):
                            return
            except BaseException as e:  # surface worker errors to consumer
                safe_put(('err', e))
                return
            safe_put(('done', None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == 'done':
                    return
                if kind == 'err':
                    raise payload
                yield payload
        finally:
            stop.set()


# -- process-pool worker plumbing (module level: must be picklable) --------

_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(index):
    return _WORKER_DATASET[int(index)]
