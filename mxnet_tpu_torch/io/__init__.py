"""``mx.io`` of the PyTorch port (counterpart of ``mxnet_tpu/io``): the
data iterators and the content-addressed blob store the KV spill tier's
disk layer uses (:mod:`.cache`).

Iterators read and batch on the host and hand each batch to the device
once: the caller's device scope when the iterator is made (``with
mx.cpu():``), else ``gpu(0)``, which raises without a card. The device
is fixed at construction, so a :class:`PrefetchingIter`'s thread
uploads where its caller asked.

:class:`ImageRecordIter` reads ``pack_img`` records (IRHeader and an
image payload) through a read-ahead thread and decodes them on the host
(``.npy`` payloads without PIL, JPEG and PNG through it); records must
already be of ``data_shape``. The reference's native C++ decode engine
(``rand_crop``, ``rand_mirror``, ``use_native=True``, ``num_workers >
0``, ``cache_dir`` or ``MXNET_TPU_IO_CACHE``) is ROADMAP item 9a-2, and
those options raise :class:`MXNetError` naming it, as the reference
does where its native library is absent; its dataset service
(``use_service``, ``MXNET_TPU_IO_SERVICE[_NET]``) is item 9b and raises
likewise. :class:`LibSVMIter` returns its batches as torch sparse CSR
tensors (the port's ``CSRNDArray`` is ROADMAP item 3).
"""
from __future__ import annotations

import os
import queue
import threading
from collections import namedtuple
from typing import List

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import to_numpy as _to_numpy
from ..recordio import ThreadedRecordReader, unpack_img
from . import cache  # noqa: F401

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ImageRecordIter", "ResizeIter", "PrefetchingIter", "CSVIter",
           "LibSVMIter", "cache"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    """One batch: lists of data and label arrays, and ``pad``, the count
    of filler samples at its end."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) else [data]
        self.label = (label if isinstance(label, (list, tuple))
                      else [label] if label is not None else [])
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base: ``next()`` returns a :class:`DataBatch`,
    ``reset()`` starts the next epoch."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self) -> DataBatch:
        return self.next()

    def next(self) -> DataBatch:
        raise NotImplementedError

    @property
    def provide_data(self) -> List[DataDesc]:
        raise NotImplementedError

    @property
    def provide_label(self) -> List[DataDesc]:
        raise NotImplementedError


def _upload(batch, dev, pin=False):
    """Host numpy -> tensor on ``dev``; float64 becomes float32 (the
    mx.np default). ``pin``: through pinned host memory (torch's caching
    host allocator) by a ``non_blocking`` copy. Tensors move to ``dev``,
    tuples and lists map, other leaves pass through."""
    if isinstance(batch, onp.ndarray):
        if batch.dtype == onp.float64:
            batch = batch.astype(onp.float32)
        host = torch.from_numpy(onp.ascontiguousarray(batch))
        if dev.type != "cuda":
            return host
        if pin:
            return host.pin_memory().to(dev, non_blocking=True)
        return host.to(dev)
    if isinstance(batch, torch.Tensor):
        return batch.to(dev)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_upload(b, dev, pin) for b in batch)
    return batch


_SERVICE_VARS = ("MXNET_TPU_IO_SERVICE", "MXNET_TPU_IO_SERVICE_NET")


def _service_armed(var):
    """Whether the reference arms its service from ``var``: any
    ``MXNET_TPU_IO_SERVICE`` root, and ``MXNET_TPU_IO_SERVICE_NET`` but
    for its own false words (``service_root_from_env`` and
    ``service_net_from_env`` in ``io/service.py``)."""
    val = os.environ.get(var, "")
    if var == "MXNET_TPU_IO_SERVICE":
        return bool(val)
    return val.strip().lower() not in ("", "0", "off", "false", "no")


def _service_check(use_service, who):
    """The dataset service (``io/service.py``) is not ported: raise where
    the reference would consume it, that is with ``use_service=True``,
    or with ``None`` and a service variable set; ``False`` opts out."""
    if use_service is False:
        return
    if use_service:
        raise MXNetError(
            f"{who}(use_service=True): the ambient dataset service "
            "(io/service.py) is not ported yet (ROADMAP item 9b)")
    armed = [v for v in _SERVICE_VARS if _service_armed(v)]
    if armed:
        raise MXNetError(
            f"{who}: {', '.join(armed)} is set, but the ambient dataset "
            "service (io/service.py) is not ported yet (ROADMAP item 9b); "
            "unset it or pass use_service=False")


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (host copies are kept);
    ``last_batch_handle`` is 'pad' (wrap to the epoch's start and report
    ``pad``), 'discard' or 'roll_over' (the tail leads the next
    epoch's first batch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._dev = resolve_device()
        self._data = self._normalize(data, data_name)
        self._label = (self._normalize(label, label_name)
                       if label is not None else [])
        self._shuffle = shuffle
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"bad last_batch_handle {last_batch_handle!r}")
        self._lbh = last_batch_handle
        self._n = self._data[0][1].shape[0]
        for name, arr in self._data + self._label:
            if arr.shape[0] != self._n:
                raise MXNetError(f"array {name} length {arr.shape[0]} != {self._n}")
        self._order = onp.arange(self._n)
        self._cursor = 0
        self._rolled = 0
        self._leftover = None
        self.reset()

    @staticmethod
    def _normalize(data, default_name):
        if isinstance(data, dict):
            return [(k, _to_numpy(v)) for k, v in data.items()]
        if isinstance(data, (list, tuple)):
            return [(f"{default_name}{i}" if i else default_name, _to_numpy(v))
                    for i, v in enumerate(data)]
        return [(default_name, _to_numpy(data))]

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:], str(a.dtype))
                for n, a in self._data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:], str(a.dtype))
                for n, a in self._label]

    def reset(self):
        if self._rolled:
            self._leftover = self._order[len(self._order) - self._rolled:].copy()
        order = onp.arange(self._n)
        if self._shuffle:
            onp.random.shuffle(order)
        if self._leftover is not None and self._leftover.size:
            # the leftover ids lead the first batch: not again this epoch
            order = order[~onp.isin(order, self._leftover)]
        self._order = order
        self._cursor = 0
        self._rolled = 0

    def next(self) -> DataBatch:
        m = len(self._order)
        if self._leftover is not None:
            take = self.batch_size - len(self._leftover)
            idx = onp.concatenate([self._leftover, self._order[:take]])
            self._leftover = None
            self._cursor = take
            pad = 0
        else:
            start = self._cursor
            if start >= m:
                raise StopIteration
            end = start + self.batch_size
            if end > m:
                if self._lbh == "discard":
                    raise StopIteration
                if self._lbh == "roll_over":
                    self._rolled = m - start
                    raise StopIteration
            pad = max(0, end - m)
            idx = self._order[start:min(end, m)]
            if pad:
                idx = onp.concatenate([idx, self._order[:pad]])
            self._cursor = end
        data = [_upload(a[idx], self._dev) for _, a in self._data]
        label = [_upload(a[idx], self._dev) for _, a in self._label]
        return DataBatch(data, label, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def _native_only(what):
    return MXNetError(
        f"ImageRecordIter({what}) runs in the native C++ decode engine, "
        "which is not ported yet (ROADMAP item 9a-2); the port decodes "
        "pre-shaped records on the host")


class ImageRecordIter(DataIter):
    """Batches of images from a RecordIO file of ``pack_img`` records,
    decoded on the host (see the module's text for the options that
    raise). Data is ``dtype`` NCHW, labels float32 (``(B,)`` at
    ``label_width`` 1); with ``round_batch`` a short tail batch repeats
    its last image and reports ``pad``."""

    def __init__(self, path_imgrec, batch_size, data_shape,
                 label_width=1, shuffle_chunk=False, round_batch=True,
                 prefetch_capacity=64, dtype="float32",
                 rand_crop=False, rand_mirror=False, min_area=0.08,
                 seed=0, preprocess_threads=2, use_native=None,
                 num_workers=0, path_imgidx=None, cache_dir=None,
                 use_service=None):
        super().__init__(batch_size)
        _service_check(use_service, "ImageRecordIter")
        if cache_dir is None:
            cache_dir = os.environ.get("MXNET_TPU_IO_CACHE") or None
        for what, on in (("rand_crop", rand_crop),
                         ("rand_mirror", rand_mirror),
                         ("use_native=True", use_native),
                         (f"num_workers={num_workers}", num_workers > 0),
                         ("cache_dir", cache_dir)):
            if on:
                raise _native_only(what)
        self._dev = resolve_device()
        self.path = path_imgrec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._round = round_batch
        self._dtype = dtype
        self._cap = prefetch_capacity
        self._reader = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc("softmax_label", shape, "float32")]

    def reset(self):
        if self._reader is not None:
            self._reader.close()
        self._reader = ThreadedRecordReader(self.path, capacity=self._cap)

    def close(self):
        """Stop the read-ahead thread and close the file."""
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def next(self) -> DataBatch:
        pad = 0
        imgs, labels = [], []
        for _ in range(self.batch_size):
            rec = next(self._reader, None)
            if rec is None:
                break
            header, img = unpack_img(rec)
            if img.shape != self.data_shape:
                if (img.ndim == 3
                        and (img.shape[2],) + img.shape[:2] == self.data_shape):
                    img = img.transpose(2, 0, 1)  # HWC -> CHW
                else:
                    raise MXNetError(
                        f"record image shape {img.shape} incompatible "
                        f"with data_shape {self.data_shape}")
            imgs.append(onp.asarray(img, dtype=self._dtype))
            labels.append(onp.asarray(header.label, dtype=onp.float32))
        if not imgs:
            raise StopIteration
        while len(imgs) < self.batch_size and self._round:
            pad += 1
            imgs.append(imgs[-1])
            labels.append(labels[-1])
        data = _upload(onp.stack(imgs), self._dev)
        lab = onp.stack(labels)
        if lab.ndim > 1 and lab.shape[1] == 1:
            lab = lab[:, 0]
        return DataBatch([data], [_upload(lab, self._dev)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class ResizeIter(DataIter):
    """``size`` batches of ``data_iter`` per epoch, resetting it when it
    runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self._it = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._count = 0

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label

    def reset(self):
        self._count = 0
        if self._reset_internal:
            self._it.reset()

    def next(self):
        if self._count >= self._size:
            raise StopIteration
        self._count += 1
        try:
            return self._it.next()
        except StopIteration:
            self._it.reset()
            return self._it.next()


class PrefetchingIter(DataIter):
    """Reads ``capacity`` batches ahead of its caller on a thread."""

    def __init__(self, iters, rename_data=None, rename_label=None, capacity=2):
        it = iters[0] if isinstance(iters, (list, tuple)) else iters
        super().__init__(it.batch_size)
        self._it = it
        self._capacity = capacity
        self._q = None
        self._stop = threading.Event()
        self._thread = None
        self._done = False
        self._start()

    def _start(self):
        # a fresh queue per producer: one unblocked by reset()'s drain
        # may put a last stale item, into the abandoned queue
        self._q = q = queue.Queue(maxsize=self._capacity)

        def run():
            try:
                while not self._stop.is_set():
                    try:
                        batch = self._it.next()
                    except StopIteration:
                        q.put(None)
                        return
                    q.put(batch)
            except Exception as e:  # noqa: BLE001 — raised at next()
                q.put(e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join()
        self._stop.clear()
        self._done = False
        self._it.reset()
        self._start()

    def next(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item


def _file_iter_next_indices(cursor, batch_size, n, round_batch):
    """The file iterators' tail logic: ``(idx, pad, new_cursor)``; with
    ``round_batch`` the tail wraps to the file's start and reports
    ``pad``, else it is short."""
    if cursor >= n:
        raise StopIteration
    end = cursor + batch_size
    idx = onp.arange(cursor, end)
    pad = max(0, end - n)
    if pad and not round_batch:
        idx = idx[: batch_size - pad]
        pad = 0
    return idx % n, pad, end


class CSVIter(DataIter):
    """Batches of CSV rows reshaped to ``data_shape``, with an optional
    ``label_csv`` (zeros without)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32"):
        super().__init__(batch_size)
        self._dev = resolve_device()
        self.data_shape = tuple(data_shape)
        self.label_shape = tuple(label_shape)
        self._dtype = dtype
        self._data = onp.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        n = self._data.shape[0]
        self._data = self._data.reshape((n,) + self.data_shape)
        if label_csv is not None:
            self._label = onp.loadtxt(label_csv, delimiter=",",
                                      dtype="float32", ndmin=2)
            self._label = self._label.reshape((n,) + self.label_shape)
        else:
            self._label = onp.zeros((n,) + self.label_shape, onp.float32)
        self._round = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label",
                         (self.batch_size,) + self.label_shape, "float32")]

    def reset(self):
        self._cursor = 0

    def next(self) -> DataBatch:
        idx, pad, self._cursor = _file_iter_next_indices(
            self._cursor, self.batch_size, self._data.shape[0], self._round)
        return DataBatch(_upload(self._data[idx], self._dev),
                         _upload(self._label[idx], self._dev), pad=pad)


class LibSVMIter(DataIter):
    """Batches of a libsvm file (rows ``label idx:val idx:val ...``) as
    torch sparse CSR tensors of ``(B, data_shape[0])``."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 round_batch=True, dtype="float32"):
        super().__init__(batch_size)
        self._dev = resolve_device()
        if isinstance(data_shape, int):
            data_shape = (data_shape,)
        self.data_shape = tuple(data_shape)
        if len(self.data_shape) != 1:
            raise MXNetError(
                "LibSVMIter data_shape must be 1-D (CSR batches are 2-D); "
                f"got {self.data_shape}")
        rows, labels = [], []
        self._dtype = dtype
        with open(data_libsvm) as f:
            for lineno, line in enumerate(f, 1):
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = []
                for kv in parts[1:]:
                    col, sep, val = kv.partition(":")
                    if not sep:
                        raise MXNetError(
                            f"{data_libsvm}:{lineno}: malformed libsvm "
                            f"token {kv!r} (expected 'index:value')")
                    col = int(col)
                    if col >= self.data_shape[0]:
                        raise MXNetError(
                            f"{data_libsvm}:{lineno}: feature index {col} "
                            f">= data_shape {self.data_shape[0]}")
                    row.append((col, float(val)))
                rows.append(row)
        self._rows = rows
        self._labels = onp.asarray(labels, onp.float32)
        self._round = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,), "float32")]

    def reset(self):
        self._cursor = 0

    def next(self) -> DataBatch:
        idx, pad, self._cursor = _file_iter_next_indices(
            self._cursor, self.batch_size, len(self._rows), self._round)
        indptr = [0]
        indices, values = [], []
        for i in idx:
            for col, val in self._rows[i]:
                indices.append(col)
                values.append(val)
            indptr.append(len(indices))
        data = torch.sparse_csr_tensor(
            torch.tensor(indptr, dtype=torch.int64),
            torch.tensor(indices, dtype=torch.int64),
            torch.from_numpy(onp.asarray(values, self._dtype)),
            size=(len(idx), self.data_shape[0]),
            check_invariants=True).to(self._dev)
        return DataBatch(data, _upload(self._labels[idx], self._dev), pad=pad)
