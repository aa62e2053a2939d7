"""DataLoader: the input pipeline — port of `paddle_tpu/io/dataloader.py`.

Batches are collated in numpy (`default_collate_fn`) and become port
Tensors on the current place. For the card, each array is copied into
pinned host memory and sent with a non-blocking copy, so the transfer
overlaps the step that runs meanwhile; the reference double-buffers
into the device the same way.

- `num_workers=0`: one background thread reads, collates and sends up
  to `prefetch_factor` batches ahead of the consumer.
- `num_workers>0`: worker processes (spawned; they hold no device
  state) take index lists from per-worker queues and return collated
  numpy batches over one `mp.Queue`; the parent keeps
  `2 * num_workers` batches in flight and yields them in order.

The reference's shared-memory worker transport (`core/native` ShmRing)
is not ported: the reference itself takes the `mp.Queue` path when
its native library is absent. Neither is the profiler's reader-cost
hook.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import threading
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.place import current_place
from ..core.tensor import Tensor
from .dataset import BatchSampler, Dataset, IterableDataset

__all__ = ["DataLoader", "default_collate_fn", "WorkerInfo"]


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    return np.asarray(batch)


def _send(arr: np.ndarray) -> Tensor:
    """A numpy batch as a Tensor on the current place (float64 becomes the
    default dtype, as `to_tensor` does); to the card through pinned
    memory with a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.dtype == np.float64:
        t = t.to(dtype_mod.default_torch())
    dev = current_place().torch_device()
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return Tensor._wrap(t)


def _to_device(collated):
    if isinstance(collated, np.ndarray):
        return _send(collated)
    if isinstance(collated, dict):
        return {k: _to_device(v) for k, v in collated.items()}
    if isinstance(collated, (list, tuple)):
        return type(collated)(_to_device(v) for v in collated)
    return collated


class WorkerInfo:
    """`get_worker_info()` inside a worker process."""

    def __init__(self, wid, dataset):
        self.id = wid
        self.dataset = dataset
        self.num_workers = int(os.environ.get("PADDLE_NUM_WORKERS", "1"))


_worker_info = None


def _worker_loop(dataset, index_queue, data_queue, collate_fn,
                 worker_init_fn, worker_id):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_id, indices = item
        try:
            samples = [dataset[i] for i in indices]
            data_queue.put((batch_id, collate_fn(samples), None))
        except Exception:  # noqa: BLE001 — the parent re-raises it
            data_queue.put((batch_id, None, traceback.format_exc()))


class _MultiProcessIter:
    def __init__(self, loader):
        self._batches = list(loader.batch_sampler)
        self._num_workers = loader.num_workers
        collate = loader.collate_fn or default_collate_fn
        ctx = mp.get_context("spawn")   # never fork a process holding CUDA
        self._index_queues = [ctx.SimpleQueue()
                              for _ in range(self._num_workers)]
        self._data_queue = ctx.Queue()
        self._workers = []
        saved = {k: os.environ.get(k)
                 for k in ("PADDLE_NUM_WORKERS", "CUDA_VISIBLE_DEVICES")}
        try:
            os.environ["PADDLE_NUM_WORKERS"] = str(self._num_workers)
            os.environ["CUDA_VISIBLE_DEVICES"] = ""   # workers: host only
            for wid in range(self._num_workers):
                w = ctx.Process(
                    target=_worker_loop,
                    args=(loader.dataset, self._index_queues[wid],
                          self._data_queue, collate, loader.worker_init_fn,
                          wid),
                    daemon=True)
                w.start()
                self._workers.append(w)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._send_idx = 0
        self._rcv_buffer = {}
        self._next_batch = 0
        self._shutdown = False
        for _ in range(min(max(2 * self._num_workers, 2),
                           len(self._batches))):
            self._dispatch()

    def _dispatch(self):
        if self._send_idx < len(self._batches):
            wid = self._send_idx % self._num_workers
            self._index_queues[wid].put(
                (self._send_idx, self._batches[self._send_idx]))
            self._send_idx += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_batch >= len(self._batches):
            self._teardown()
            raise StopIteration
        while self._next_batch not in self._rcv_buffer:
            try:
                batch_id, data, err = self._data_queue.get(timeout=5.0)
            except queue.Empty:
                dead = [w for w in self._workers if not w.is_alive()]
                if dead:
                    self._teardown()
                    raise RuntimeError(
                        f"DataLoader worker(s) exited unexpectedly "
                        f"(exitcodes {[w.exitcode for w in dead]})")
                continue
            if err is not None:
                self._teardown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self._rcv_buffer[batch_id] = data
        data = self._rcv_buffer.pop(self._next_batch)
        self._next_batch += 1
        self._dispatch()
        return _to_device(data)

    def _teardown(self):
        if self._shutdown:
            return
        self._shutdown = True
        for q in self._index_queues:
            q.put(None)
        for w in self._workers:
            w.join(timeout=2)
            if w.is_alive():
                w.terminate()
                w.join(timeout=2)
        self._data_queue.close()
        self._data_queue.join_thread()

    def __del__(self):
        try:
            self._teardown()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


class _SingleProcessIter:
    """A background thread reads, collates and sends batches ahead."""

    def __init__(self, loader):
        self._loader = loader
        self._collate = loader.collate_fn or default_collate_fn
        self._batch_iter = iter(loader.batch_sampler)
        self._buffer: "queue.Queue" = queue.Queue(
            maxsize=loader.prefetch_factor)
        self._done = object()
        self._stop = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self._buffer.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for indices in self._batch_iter:
                if self._stop:
                    return
                samples = [self._loader.dataset[i] for i in indices]
                if not self._put(_to_device(self._collate(samples))):
                    return
            self._put(self._done)
        except Exception:  # noqa: BLE001 — re-raised in the consumer
            self._put(RuntimeError(traceback.format_exc()))

    def __iter__(self):
        return self

    def __next__(self):
        item = self._buffer.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, RuntimeError):
            raise item
        return item

    def close(self):
        """Unblock the producer, so an abandoned iterator holds no batch."""
        self._stop = True
        try:
            while True:
                self._buffer.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


class _IterableDatasetIter:
    def __init__(self, loader):
        self._collate = loader.collate_fn or default_collate_fn
        self._it = iter(loader.dataset)
        self._batch_size = loader.batch_size
        self._drop_last = loader.drop_last

    def __iter__(self):
        return self

    def __next__(self):
        batch = list(itertools.islice(self._it, self._batch_size))
        if not batch or (self._drop_last and len(batch) < self._batch_size):
            raise StopIteration
        return _to_device(self._collate(batch))


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True,
                 batch_sampler: Optional[BatchSampler] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 use_buffer_reader: bool = True, prefetch_factor: int = 2,
                 use_shared_memory: bool = True, timeout: int = 0,
                 worker_init_fn: Optional[Callable] = None,
                 persistent_workers: bool = False):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = prefetch_factor
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.use_shared_memory = use_shared_memory
        self._is_iterable = isinstance(dataset, IterableDataset)
        if self._is_iterable:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __iter__(self):
        if self._is_iterable:
            return _IterableDatasetIter(self)
        if self.num_workers > 0:
            return _MultiProcessIter(self)
        return _SingleProcessIter(self)

    def __len__(self):
        if self._is_iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)
