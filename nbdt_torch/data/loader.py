"""Batched host data loader.

Counterpart of ``nbdt_tpu/data/loader.py``: shuffle indices with a seeded
``RandomState``, gather a uint8 batch (the native gather of
:mod:`nbdt_torch.native` where it is built, else numpy's), run the batch
transform, and yield ``(x, y, valid)`` as numpy arrays (NHWC), in the
same order, with the same ``drop_last``/``pad_last`` and shard semantics,
so the batches are byte-identical to the JAX package's per seed. The
trainer moves them to the device.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from .. import native


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        transform: Optional[Callable] = None,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        """``num_shards``/``shard_id``: each shard iterates a disjoint
        strided slice of the (identically shuffled) index order, padded so
        that every shard has the same number of batches."""
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        # Flat arrays: one fancy-index gather per batch (a label-subset
        # wrapper's new_to_old stays an index indirection); else per sample.
        self._index = None
        if hasattr(dataset, "images") and hasattr(dataset, "labels"):
            self.images = dataset.images
            self.labels = np.asarray(dataset.labels)
            if hasattr(dataset, "new_to_old"):
                self._index = np.asarray(dataset.new_to_old)
                self.labels = self.labels[self._index]
            self._n = len(self.labels)
        else:
            self.images = None
            self.labels = None
            self._n = len(dataset)

    def _gather(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.images is not None:
            src = self._index[idx] if self._index is not None else idx
            batch = None
            if (isinstance(self.images, np.ndarray) and self.images.dtype == np.uint8
                    and self.images.flags.c_contiguous):
                # releases the GIL: overlaps a PrefetchLoader's caller
                batch = native.gather_batch_u8(self.images, src)
            if batch is None:
                batch = self.images[src]
            return batch, self.labels[idx]
        samples = [self.dataset[int(i)] for i in idx]
        return np.stack([np.asarray(s[0]) for s in samples]), np.array([s[1] for s in samples])

    def _shard_size(self) -> int:
        return (self._n + self.num_shards - 1) // self.num_shards

    def __len__(self):
        n = self._shard_size()
        if self.pad_last or not self.drop_last:
            return (n + self.batch_size - 1) // self.batch_size
        return n // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (images, labels int32, valid bool) batches."""
        order = np.arange(self._n)
        if self.shuffle:
            self.rng.shuffle(order)
        real = np.ones(len(order), dtype=bool)
        if self.num_shards > 1:
            # every shard gets ceil(n / num_shards) samples; the wrapped
            # duplicates are not real, so no metric counts them twice
            total = self._shard_size() * self.num_shards
            if total > len(order):
                order = np.resize(order, total)
                real = np.concatenate([real, np.zeros(total - self._n, dtype=bool)])
            order = order[self.shard_id:: self.num_shards]
            real = real[self.shard_id:: self.num_shards]
        n = len(order)
        bs = self.batch_size
        stop = n - (n % bs) if (self.drop_last and not self.pad_last) else n
        for start in range(0, stop, bs):
            idx = order[start: start + bs]
            valid = real[start: start + bs].copy()
            if len(idx) < bs and self.pad_last:  # padded rows are not valid
                pad = bs - len(idx)
                idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
                valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
            batch, labels = self._gather(idx)
            labels = labels.astype(np.int32)
            batch = self.transform(batch) if self.transform is not None else batch.astype(
                np.float32)
            yield batch, labels, valid


class PrefetchLoader:
    """Assembles the next batches on a background thread while the caller
    works on the current one. ``depth`` bounds the queue."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        errors = []
        stop = threading.Event()

        def bounded_put(item) -> bool:
            # a consumer that leaves mid-epoch must not strand the producer
            # on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self.loader:
                    if not bounded_put(item):
                        return
            except BaseException as e:  # handed to the consumer, raised there
                errors.append(e)
            finally:
                bounded_put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)
        if errors:
            raise errors[0]
