"""Host-side dataset batching for training.

The port's own copy of ``glomeruli_segmentation_tpu/data/dataset.py``
(numpy, cv2 and PIL, the last two imported where they are used); a test
holds the two loaders' batches byte-identical under one seed.  Equivalent
of the reference's ``MyDataset`` + torch ``DataLoader`` workers
(``module/espnet/train/DataSet.py``, ``main.py:331-353``): decodes
image/label pairs with cv2/PIL, applies the transform pipeline, and yields
stacked NHWC batches.  Decoding runs in a thread pool (cv2 releases the
GIL), and a bounded producer thread keeps ``prefetch`` batches staged
ahead of the consumer, so host decode of batch N+1 overlaps the device
step on batch N.
"""
from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np


class SegmentationDataset:
    def __init__(self, im_list: Sequence[str], annot_list: Sequence[str],
                 transform=None):
        assert len(im_list) == len(annot_list)
        self.im_list = list(im_list)
        self.annot_list = list(annot_list)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.im_list)

    def get(self, idx: int, rng: np.random.Generator):
        import cv2
        from PIL import Image

        image = cv2.imread(self.im_list[idx])
        label = np.asarray(Image.open(self.annot_list[idx]))
        if self.transform is not None:
            image, label = self.transform(rng, image, label)
        return image, label


def _default_collate(items) -> Tuple[np.ndarray, np.ndarray]:
    return (np.stack([it[0] for it in items]),
            np.stack([it[1] for it in items]))


class DataLoader:
    """Shuffled, threaded batch iterator over any dataset exposing
    ``__len__`` and ``get(idx, rng)``.  ``collate`` turns the list of
    per-item results into a batch (default: stack (image, label) pairs)."""

    def __init__(self, dataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 seed: int = 0, drop_last: bool = False,
                 prefetch: int = 1, collate=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.collate = collate or _default_collate
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            rng.shuffle(order)
        self.epoch += 1

        def load(idx_seed):
            idx, seed = idx_seed
            return self.dataset.get(idx, np.random.default_rng(seed))

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, self.batch_size):
                chunk = order[start: start + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                seeds = rng.integers(0, 2**63, size=len(chunk))
                items = list(pool.map(load, zip(chunk, seeds)))
                yield self.collate(items)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return prefetch_iter(self._batches(), self.prefetch)


def prefetch_iter(it, depth: int):
    """Stage up to ``depth`` items from generator ``it`` ahead of the
    consumer on a bounded producer thread.  Yields the same items in the
    same order as consuming ``it`` directly (the rng draws happen in
    generation order inside ``it``); only the staging overlaps the
    consumer.  ``depth <= 0`` is the synchronous passthrough."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            # check stop before each decode (not only before each put):
            # an abandoning consumer must not pay for one more batch
            while not stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    put(done)
                    return
                if not put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # shut the decode pool down deterministically

    worker = threading.Thread(target=produce, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer mid-put
            try:
                q.get_nowait()
            except queue.Empty:
                break
        worker.join()
