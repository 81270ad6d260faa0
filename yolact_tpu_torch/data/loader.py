"""Threaded prefetching batch loader: the port's copy of
``yolact_tpu/data/loader.py``.

Replaces torch's DataLoader + the reference's CustomDataParallel scatter
(``train.py:149-162,399-437``): worker threads decode/augment images (numpy
releases the GIL), batches are padded to fixed shapes
(``data.coco.pad_batch``) and queued so the accelerator never waits on the
host.  With ``pin_memory`` the workers hand over the batch as page-locked
CPU tensors, so the train step's ``non_blocking`` copy to the card
(``train/step.py:batch_to_device``) is an asynchronous DMA instead of a
staged pageable copy.

The JAX loader's two transports: ``pack_masks`` (on by default, as in
JAX) ships full-resolution masks bit-packed as ``gt_masks_packed``
(``data/coco.py:pack_batch_masks``; the ``multires`` targets come packed
from ``pad_batch`` already), and ``pack_images`` ships raw [0,255] images
as uint8 for on-device augmentation (``data/device_augment.py``), rounded
and clipped; the first batch is checked for host-normalized (negative)
pixels, which packing would destroy.  The train step unpacks and casts on
the card (``train/step.py``).

Data parallelism: with ``rank`` and ``world``, ``batch_size`` is the global
batch; every rank shuffles with the same seed and loads, augments and
delivers only its rows ``[rank * b / world, (rank + 1) * b / world)`` of
each global batch (``parallel/mesh.py:shard_batch``'s rows).  Under a
spatial split ``rank`` and ``world`` are the data rank and the data ranks'
count: the space ranks of a data rank load the same rows, whole images,
each augmented on its own rank's draws (the train step takes space rank
0's copy and keeps its rows of the height).

Determinism: like torch's DataLoader, batches are delivered in epoch order
regardless of which worker finishes first — the feeder stamps each index
list with a sequence number and the consumer reorders.  A fixed seed
therefore reproduces the exact batch-at-step-k sequence.

Worker exceptions propagate to the consumer (like torch's DataLoader):
a failing ``pull_item`` surfaces as a RuntimeError from ``next_batch`` /
iteration instead of a silently dead thread and a hung training loop;
``next_batch`` after ``stop()`` raises instead of blocking forever.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Iterator

import numpy as np
import torch

from yolact_tpu_torch.data.coco import (COCODetection, pack_batch_masks,
                                        pad_batch)
from yolact_tpu_torch.utils import timer


class _WorkerError:
    """Sentinel carrying a worker thread's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc
        self.tb = traceback.format_exc()


class BatchLoader:
    def __init__(self, dataset: COCODetection, batch_size: int,
                 max_gt: int = 100, shuffle: bool = True,
                 num_workers: int = 2, prefetch: int = 4, seed: int = 0,
                 drop_last: bool = True, pack_masks: bool = True,
                 pack_images: bool = False, multires=None,
                 pin_memory: bool = False, rank: int = 0, world: int = 1):
        if len(dataset) < batch_size and drop_last:
            raise ValueError(
                f'dataset has {len(dataset)} items < batch_size '
                f'{batch_size} with drop_last=True: zero batches per epoch')
        if batch_size % world:
            raise ValueError(f'batch_size {batch_size} does not divide over '
                             f'{world} ranks')
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank_rows = slice(rank * batch_size // world,
                               (rank + 1) * batch_size // world)
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.pack_masks = pack_masks
        # raw-pixel batches (use_device_augment) ship as uint8: 4x less
        # host-to-device copy; the train step casts to float on the card
        self.pack_images = pack_images
        self._pack_checked = False
        # pre-downsampled gt mask targets (see data.coco.pad_batch):
        # {'proto': (Hp, Wp), 'seg': (Hs, Ws) | None} or None
        self.multires = multires
        self.pin_memory = pin_memory
        self._stop = threading.Event()
        self._batch_queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        # bounded: backpressure for the feeder, which otherwise enqueues
        # whole epochs of index lists as fast as it can shuffle them
        self._index_queue: "queue.Queue" = queue.Queue(
            maxsize=max(2 * self.num_workers, 4))
        self._threads = []
        self._started = False
        # in-order delivery state (consumer side)
        self._next_seq = 0
        self._hold: dict = {}

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _worker(self):
        while not self._stop.is_set():
            try:
                seq, idxs, n_valid = self._index_queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                items = [self.dataset.pull_item(i) for i in idxs]
                imgs = [it[0] for it in items]
                targets = [it[1] for it in items]
                masks = [it[2] for it in items]
                crowds = [it[5] for it in items]
                batch = pad_batch(imgs, targets, masks, crowds, self.max_gt,
                                  multires=self.multires)
                if n_valid < len(idxs):
                    # drop_last=False pads the final short batch by
                    # wrapping around — mark how many rows are real so
                    # consumers don't double-count the duplicates
                    batch['num_valid'] = n_valid
                if self.pack_masks and self.multires is None:
                    batch = pack_batch_masks(batch)
                if self.pack_images:
                    img = batch['image']
                    if not self._pack_checked:
                        if float(img.min()) < 0.0:
                            raise ValueError(
                                'pack_images=True requires raw [0,255] '
                                'pixels; got negative values (the batch '
                                'looks host-normalized; packing would '
                                'destroy it)')
                        self._pack_checked = True
                    batch['image'] = np.clip(
                        np.round(img), 0, 255).astype(np.uint8)
                if self.pin_memory:
                    batch = {k: torch.from_numpy(v).pin_memory()
                             if isinstance(v, np.ndarray) else v
                             for k, v in batch.items()}
            except BaseException as e:  # propagate to the consumer
                batch = _WorkerError(e)
            while not self._stop.is_set():
                try:
                    self._batch_queue.put((seq, batch), timeout=0.25)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, _WorkerError):
                return

    def _feeder(self):
        seq = 0
        while not self._stop.is_set():
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self.rng.shuffle(order)
            nb = len(self)
            for b in range(nb):
                if self._stop.is_set():
                    return
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                n_valid = len(idxs)
                if len(idxs) < self.batch_size:
                    # wrap around (tiling if the dataset is smaller than
                    # one batch) so shapes stay static
                    idxs = np.resize(
                        np.concatenate([idxs, order]), self.batch_size)
                # this rank's rows, and how many of them are real
                first = self.rank_rows.start
                idxs = idxs[self.rank_rows]
                n_valid = min(max(n_valid - first, 0), len(idxs))
                while not self._stop.is_set():
                    try:
                        self._index_queue.put((seq, list(idxs), n_valid),
                                              timeout=0.25)
                        break
                    except queue.Full:
                        continue
                seq += 1

    def start(self):
        if self._started:
            return
        self._started = True
        t = threading.Thread(target=self._feeder, daemon=True)
        t.start()
        self._threads.append(t)
        for _ in range(self.num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _check(self, item):
        if isinstance(item, _WorkerError):
            self.stop()
            raise RuntimeError(
                f'BatchLoader worker failed:\n{item.tb}') from item.exc
        return item

    def __iter__(self) -> Iterator[dict]:
        """One epoch of batches, in order (len(self) of them)."""
        self.start()
        for _ in range(len(self)):
            yield self.next_batch()

    def next_batch(self) -> dict:
        """The next batch in epoch order (deterministic for a fixed seed);
        epochs stream back-to-back.  Raises after stop() or a worker
        error instead of blocking forever.  While ``utils/timer.py``
        records, counts the batches already held or queued on entry
        (``loader_ready``)."""
        self.start()
        if timer.active():
            timer.count('loader_ready',
                        len(self._hold) + self._batch_queue.qsize())
        while True:
            if self._next_seq in self._hold:
                batch = self._hold.pop(self._next_seq)
                self._next_seq += 1
                return self._check(batch)
            # errors jump the reorder queue — deliver immediately
            for k, v in list(self._hold.items()):
                if isinstance(v, _WorkerError):
                    del self._hold[k]
                    return self._check(v)
            try:
                seq, batch = self._batch_queue.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError(
                        'BatchLoader is stopped (stop() was called or a '
                        'worker error was raised earlier)')
                continue
            self._hold[seq] = batch

    def stop(self):
        self._stop.set()
