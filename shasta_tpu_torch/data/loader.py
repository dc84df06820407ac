"""Host data loader: parallel sample building and batch prefetch. The port
of shasta_tpu/data/loader.py.

Replaces torch DataLoader + DistributedGroupSampler
(det3d/datasets/loader/build_loader.py:24-60, sampler.py) with the JAX
package's order, which torch.utils.data.DataLoader does not give: the
indices shuffled by default_rng(seed + epoch), then this shard's
[shard_id::num_shards], then cut to whole batches (drop_last). Samples are
built in a thread pool (the voxelizer releases the interpreter lock) and
collated batches wait in a prefetch queue. Each process of a data-parallel
run takes shard_id=rank, num_shards=world (parallel/dist.py).

The threads share the dataset's one generator: with more than one worker
the draws (detection subsampling, sweep choice, augmentation) follow the
threads' timing, as in the JAX package. num_workers=1 keeps them in order.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .nuscenes import collate


class ConcatDataset:
    """Chain several datasets (det3d/datasets/dataset_wrappers.py
    ConcatDataset): indices run through each dataset in order."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self._offsets[di])]


class RepeatDataset:
    """Repeat a dataset `times` times per epoch (dataset_wrappers.py
    RepeatDataset), the reference's trick for short schedules."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = int(times)

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx: int):
        return self.dataset[idx % len(self.dataset)]


class DataLoader:
    """Batches of `batch_size` collated samples, this shard's, in the
    epoch's order; `epoch` picks the shuffle and advances after each full
    pass (the trainer's EpochSeedHook sets it)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 4,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2, shard_id: int = 0,
                 num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_id::self.num_shards]

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        nb = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                        out_q.put(collate(list(pool.map(self.dataset.__getitem__, sel))))
                out_q.put(None)
            except Exception as e:  # handed to the consumer, which raises it
                out_q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():  # let a producer blocked on a full queue see stop
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
        self.epoch += 1
