"""DataLoader of the PyTorch port (the port's own copy of
``mxnet_tpu/gluon/data/dataloader.py``).

Samples stay host numpy up to the batch boundary; the parent uploads
each batch once, to the device resolved when iteration starts (the
caller's ``with mx.cpu():`` scope, else ``gpu(0)``, which raises
without a card). float64 becomes float32, the
mx.np default. With ``pin_memory=True`` a batch is copied into pinned
host memory (torch's caching host allocator, which reuses a block once
the copy that read it has finished) and sent with a ``non_blocking``
copy.

Workers: ``num_workers > 0`` forks a process pool (``thread_pool=True``:
a thread pool). Forked workers return host numpy and never touch CUDA;
a dataset whose first sample holds a CUDA tensor is refused up front
with :class:`MXNetError`, since reading it in a forked child would
fail there. ``prefetch`` (default ``2 * num_workers``) batches are
fetched and uploaded ahead, on a thread when there is no pool.

The reference's ambient dataset service (``io/service.py``) is ROADMAP
item 9b: ``use_service=True`` raises :class:`MXNetError`, and so does an
``MXNET_TPU_IO_SERVICE`` or ``MXNET_TPU_IO_SERVICE_NET`` variable unless
``use_service=False`` opts out. Each batch fetch is the
``dataloader.next`` chaos site, inside a bounded retry of transient IO
errors (:mod:`~mxnet_tpu_torch.resilience.retry`).
"""
from __future__ import annotations

import multiprocessing
import queue
import threading
from typing import Callable, Optional

import torch

from ...base import MXNetError
from ...context import resolve_device
from ...io import _service_check, _upload
from ...resilience import chaos
from ...resilience.retry import RetriesExhausted, RetryPolicy, call_with_retry
from .batchify import default_batchify_fn
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader"]

# transient IO gets a bounded in-place retry at the batch boundary: 3
# attempts, short backoff; past that the fetch fails naming the index
_FETCH_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.02,
                           max_delay_s=0.5)


def _fetch_batch(dataset, batchify_fn, batch_idx):
    """One guarded batch fetch: the ``dataloader.next`` chaos site and a
    bounded retry around transient errors. Runs in the parent and in
    pool workers alike."""
    failing = {"i": None}

    def once():
        chaos.site("dataloader.next")
        samples = []
        for i in batch_idx:
            failing["i"] = i
            samples.append(dataset[i])
        failing["i"] = None
        return batchify_fn(samples)

    try:
        return call_with_retry(once, policy=_FETCH_RETRY)
    except RetriesExhausted as e:
        where = (f"at dataset index {failing['i']}"
                 if failing["i"] is not None
                 else "outside dataset access (injected fault or batchify)")
        raise MXNetError(
            f"DataLoader batch fetch failed after "
            f"{_FETCH_RETRY.max_attempts} attempts {where} "
            f"(batch {list(batch_idx)[:8]}): {e.__cause__!r}") from e


def _holds_cuda(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (tuple, list)):
        return any(_holds_cuda(o) for o in obj)
    return False


class DataLoader:
    """Batches of a dataset on the device: ``for data, label in
    loader``. See the module's text for workers, pinning, the device and
    the refused options."""

    def __init__(
        self,
        dataset,
        batch_size: Optional[int] = None,
        shuffle: bool = False,
        sampler=None,
        last_batch: Optional[str] = None,
        batch_sampler=None,
        batchify_fn: Optional[Callable] = None,
        num_workers: int = 0,
        pin_memory: bool = False,
        prefetch: Optional[int] = None,
        thread_pool: bool = False,
        timeout: int = 120,
        use_service: Optional[bool] = None,
    ):
        _service_check(use_service, "DataLoader")
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._use_service = use_service

        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        elif any(p is not None for p in (batch_size, sampler, last_batch)) or shuffle:
            raise MXNetError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pool = None
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool

                self._pool = ThreadPool(self._num_workers)
            else:
                if len(dataset) and _holds_cuda(dataset[0]):
                    raise MXNetError(
                        "DataLoader(num_workers>0) forks workers, which "
                        "must not touch CUDA, but the dataset's samples "
                        "hold CUDA tensors: keep the data on the host "
                        "(ArrayDataset copies it there) or pass "
                        "thread_pool=True")
                # the dataset and batchify go once through the pool's
                # initializer (fork inherits them); a task is its indices
                ctx = multiprocessing.get_context("fork")
                self._pool = ctx.Pool(
                    self._num_workers,
                    initializer=_worker_init,
                    initargs=(dataset, self._batchify_fn),
                )

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        _service_check(self._use_service, "DataLoader")
        # the caller's device scope is thread-local: resolve it here
        dev = resolve_device()
        pin = self._pin_memory and dev.type == "cuda"
        if self._pool is None:
            gen = self._gen(dev, pin)
            if self._prefetch > 0:
                return _PrefetchIter(gen, self._prefetch)
            return gen
        return _PoolIter(self, dev, pin)

    def _gen(self, dev, pin):
        for batch_idx in self._batch_sampler:
            yield _upload(_fetch_batch(self._dataset, self._batchify_fn,
                                       batch_idx), dev, pin)

    def close(self):
        """Stop the worker pool (its processes or threads)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def _worker_fn_direct(dataset, batchify_fn, batch_idx):
    return _fetch_batch(dataset, batchify_fn, batch_idx)


_WORKER_STATE = {}


def _worker_init(dataset, batchify_fn):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["batchify_fn"] = batchify_fn


def _worker_fn(batch_idx):
    return _fetch_batch(_WORKER_STATE["dataset"],
                        _WORKER_STATE["batchify_fn"], batch_idx)


class _PoolIter:
    """In-order iterator over a worker pool, ``2 * num_workers`` batches
    in flight."""

    def __init__(self, loader: DataLoader, dev, pin):
        self._loader = loader
        self._dev, self._pin = dev, pin
        self._batches = iter(loader._batch_sampler)
        self._pending = {}
        self._sent = 0
        self._recv = 0
        for _ in range(max(2 * loader._num_workers, 2)):
            self._dispatch()

    def _dispatch(self):
        batch_idx = next(self._batches, None)
        if batch_idx is None:
            return
        pool = self._loader._pool
        if self._loader._thread_pool:
            self._pending[self._sent] = pool.apply_async(
                _worker_fn_direct,
                (self._loader._dataset, self._loader._batchify_fn, batch_idx))
        else:
            self._pending[self._sent] = pool.apply_async(_worker_fn,
                                                         (batch_idx,))
        self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._recv >= self._sent:
            raise StopIteration
        result = self._pending.pop(self._recv).get(self._loader._timeout)
        self._recv += 1
        self._dispatch()
        return _upload(result, self._dev, self._pin)


class _PrefetchIter:
    """Fetch and upload ``depth`` batches ahead on a thread; an error is
    raised at the ``next()`` that reaches it."""

    def __init__(self, gen, depth: int):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._error = None

        def run():
            try:
                for item in gen:
                    self._queue.put(item)
            except BaseException as e:  # noqa: BLE001 — surfaced on next()
                self._error = e
            finally:
                self._queue.put(self._sentinel)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._sentinel:
            self._queue.put(self._sentinel)     # stays exhausted
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
