"""Datasets of the PyTorch port (the port's own copy of
``mxnet_tpu/gluon/data/dataset.py``).

``ArrayDataset`` keeps host copies of tensor arguments (``.cpu()``), as
the reference keeps ``asnumpy()`` copies, so forked loader workers never
touch CUDA. ``RecordFileDataset`` opens its record file once per process
and reads under a lock, so forked workers and threads do not share one
file offset.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, List, Sequence

import torch

from ...base import MXNetError
from ...ndarray.ndarray import to_numpy

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn: Callable) -> "Dataset":
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Every ``num_shards``-th sample from ``index`` (per-host input
        sharding)."""
        if not 0 <= index < num_shards:
            raise MXNetError(f"shard index {index} out of range {num_shards}")
        return _SubsetDataset(self, list(range(len(self)))[index::num_shards])

    def take(self, count: int) -> "Dataset":
        return _SubsetDataset(self, list(range(min(count, len(self)))))

    def sample(self, sampler) -> "Dataset":
        return _SubsetDataset(self, list(sampler))

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        def first(*sample):
            if len(sample) == 1:
                return fn(sample[0])
            return (fn(sample[0]),) + tuple(sample[1:])

        return self.transform(_TupleSpread(first), lazy)


class _TupleSpread:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, sample):
        if isinstance(sample, tuple):
            return self._fn(*sample)
        return self._fn(sample)


class SimpleDataset(Dataset):
    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _SubsetDataset(Dataset):
    def __init__(self, base: Dataset, indices: List[int]):
        self._base = base
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._base[self._indices[idx]]


class _LazyTransformDataset(Dataset):
    def __init__(self, base: Dataset, fn: Callable):
        self._base = base
        self._fn = fn

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx):
        item = self._base[idx]
        if isinstance(self._fn, _TupleSpread):
            return self._fn(item)
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of arrays; tensors are kept as host numpy copies."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("needs at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
            if isinstance(a, torch.Tensor):
                a = to_numpy(a)
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file and its ``.idx`` sidecar: item ``i``
    is the bytes of the ``i``-th key's record."""

    def __init__(self, filename: str):
        self._filename = filename
        self._idx_file = os.path.splitext(filename)[0] + ".idx"
        self._lock = threading.Lock()
        self._pid = None
        self._open()

    def _open(self):
        from ...recordio import MXIndexedRecordIO

        self._record = MXIndexedRecordIO(self._idx_file, self._filename, "r")
        self._pid = os.getpid()

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        with self._lock:
            if self._pid != os.getpid():     # a forked worker's own handle
                self._open()
            return self._record.read_idx(self._record.keys[idx])
