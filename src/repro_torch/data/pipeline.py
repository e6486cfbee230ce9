"""Input pipeline: batching, shuffling, host sharding, curriculum ordering.

Designed for multi-host training: each process reads only its slice
(`host_shard`), batches are globally shuffled per epoch from a seeded rng,
and curriculum mode consumes a precomputed easy->hard ordering
(`repro_torch.core.distill.curriculum_order`) with a pacing schedule.

A numpy copy of the JAX package's `repro/data/pipeline.py`: the same
arguments give bit-identical batches in both packages.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def host_shard(n: int, process_index: int, process_count: int) -> slice:
    """Contiguous per-host slice of the dataset (same convention as jax
    process-local data loading)."""
    per = n // process_count
    start = process_index * per
    end = start + per if process_index < process_count - 1 else n
    return slice(start, end)


def batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    order: np.ndarray | None = None,
    limit: int | None = None,
    drop_remainder: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (x, y) batches.

    order: optional explicit index order (curriculum easy->hard); `limit`
    restricts to the first `limit` indices of that order (pacing), with
    shuffling *within* the available pool so batches stay i.i.d.-ish.
    """
    n = len(labels)
    idx = np.asarray(order) if order is not None else np.arange(n)
    if limit is not None:
        idx = idx[:limit]
    if shuffle:
        rng = np.random.RandomState((seed * 9973 + epoch) & 0x7FFFFFFF)
        idx = rng.permutation(idx)
    stop = (len(idx) // batch_size) * batch_size if drop_remainder else len(idx)
    for i in range(0, stop, batch_size):
        sel = idx[i : i + batch_size]
        if not drop_remainder and len(sel) < batch_size:
            pass
        yield images[sel], labels[sel]


def num_batches(n: int, batch_size: int, drop_remainder: bool = True) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetcher (overlap host data prep with device step)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
