"""Multi-process batch loading — the torch `num_workers` analogue.

Own copy of the JAX package's `data/mploader.py`. The reference overlapped
decode+augment with GPU compute via DataLoader worker PROCESSES
(train_meta.py:173-193); the in-tree `prefetch` thread cannot scale past one
core because the PIL/numpy decode path holds the GIL. MPLoader spawns N
worker processes, each building its own dataset objects and yielding every
N-th batch (stride partitioning); the parent drains the per-worker queues
round-robin so the global batch order is the sequential one.

Workers are started with `spawn` and never touch CUDA: they build numpy
arrays only, and only the main process copies batches to the device.
Augmentation randomness is per-worker (seed + worker_id), exactly the
reference's num_workers semantics. The multiscale width range stays on the
sequential schedule because DetectionDataset.batches pins `seen` to the
batch index when striding.
"""

from __future__ import annotations

import multiprocessing as mp
import random
import traceback
from typing import Iterator

from ..config.settings import Settings


class _WorkerError:
    def __init__(self, tb: str):
        self.tb = tb


def episode_stream(trainlist, meta_file: str, settings: Settings,
                   batch_size: int, seen: int, n_groups: int = 1, *,
                   worker_id: int = 0, num_workers: int = 1,
                   seed: int = 0) -> Iterator:
    """One worker's share of (imgs, labels, metax, mask) episodic batches.
    Module-level so `spawn` can pickle it by reference.

    n_groups must match the trainer's replica-group count: each support
    batch carries one sample per class PER GROUP (n_groups * n_cls images,
    the reference's n_cls * num_gpus layout, dataset.py:348), which
    make_episode_batch reshapes to (n_groups, n_cls, ...)."""
    from .datasets import DetectionDataset, MetaDataset

    rng = random.Random(seed + worker_id)
    ds = DetectionDataset(
        list(trainlist), settings, train=True, seen=seen, shuffle=False,
        rng=rng, filter_valid=False,
    )
    metaset = MetaDataset(
        meta_file, settings, train=True, num_replicas=n_groups, rng=rng,
    )
    meta_iter = metaset.batches(n_groups * len(metaset.classes))
    for imgs, labels in ds.batches(batch_size, offset=worker_id,
                                   stride=num_workers):
        metax, mask = next(meta_iter)
        yield imgs, labels, metax, mask


def detection_stream(trainlist, settings: Settings, batch_size: int,
                     seen: int, *, worker_id: int = 0, num_workers: int = 1,
                     seed: int = 0) -> Iterator:
    """One worker's share of plain (imgs, labels) batches."""
    from .datasets import DetectionDataset

    rng = random.Random(seed + worker_id)
    ds = DetectionDataset(
        list(trainlist), settings, train=True, seen=seen, shuffle=False,
        rng=rng, filter_valid=False,
    )
    yield from ds.batches(batch_size, offset=worker_id, stride=num_workers)


def _worker_main(factory, args, kwargs, q):
    try:
        for item in factory(*args, **kwargs):
            q.put(item)
        q.put(None)
    except BaseException:
        q.put(_WorkerError(traceback.format_exc()))


class MPLoader:
    """Round-robin multi-process loader over a module-level stream factory.

    factory(*args, worker_id=w, num_workers=W, seed=s) must yield batches
    w, w+W, 2W+w, ... of the sequential stream; MPLoader interleaves the
    workers back into sequential order.
    """

    def __init__(self, factory, args=(), num_workers: int = 2,
                 depth: int = 2, seed: int = 0):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}: at least one worker")
        # spawn: never fork a process that holds a CUDA context or threads
        ctx = mp.get_context("spawn")
        self.num_workers = num_workers
        self.queues = [ctx.Queue(maxsize=depth) for _ in range(num_workers)]
        self.procs = [
            ctx.Process(
                target=_worker_main,
                args=(factory, args,
                      {"worker_id": w, "num_workers": num_workers,
                       "seed": seed}, self.queues[w]),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        for p in self.procs:
            p.start()

    def __iter__(self):
        live = [True] * self.num_workers
        w = 0
        while any(live):
            if live[w]:
                item = self.queues[w].get()
                if item is None:
                    live[w] = False
                elif isinstance(item, _WorkerError):
                    self.close()
                    raise RuntimeError(f"loader worker failed:\n{item.tb}")
                else:
                    yield item
            w = (w + 1) % self.num_workers

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=5)
        for q in self.queues:
            q.close()
