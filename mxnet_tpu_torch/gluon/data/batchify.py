"""Batchify functions of the PyTorch port (the port's own copy of
``mxnet_tpu/gluon/data/batchify.py``).

Every function returns host numpy: batchify runs inside forked
DataLoader workers, which must never touch CUDA, and the DataLoader
uploads each batch in the parent (one transfer per array). ``Append``
returns its per-sample arrays on the host for the same reason (the
reference makes each a device array); the loader uploads them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as onp

from ...base import MXNetError
from ...ndarray.ndarray import to_numpy

__all__ = ["Stack", "Pad", "Group", "Append", "AsList", "default_batchify_fn"]


class Stack:
    """Stack samples along a new batch axis."""

    def __call__(self, data: Sequence):
        return onp.stack([to_numpy(d) for d in data])


class Pad:
    """Pad ragged samples along ``axis`` to the longest (rounded up to a
    multiple of ``round_to``) with ``val``, then stack."""

    def __init__(self, axis=0, val=0, dtype=None, round_to=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype
        self._round_to = round_to

    def __call__(self, data: Sequence):
        arrs = [to_numpy(d) for d in data]
        max_len = max(a.shape[self._axis] for a in arrs)
        if self._round_to:
            max_len = -(-max_len // self._round_to) * self._round_to
        padded = []
        for a in arrs:
            pad_width = [(0, 0)] * a.ndim
            pad_width[self._axis] = (0, max_len - a.shape[self._axis])
            padded.append(onp.pad(a, pad_width, constant_values=self._val))
        out = onp.stack(padded)
        if self._dtype:
            out = out.astype(self._dtype)
        return out


class Group:
    """Apply one batchify function per field of the sample tuple."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data: Sequence):
        if len(data[0]) != len(self._fns):
            raise MXNetError("sample arity != number of batchify functions")
        return tuple(fn([d[i] for d in data]) for i, fn in enumerate(self._fns))


def default_batchify_fn(data: Sequence):
    """Stack each field of tuple samples, or the samples themselves."""
    sample = data[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(sample)))
    return Stack()(data)


class Append:
    """Each sample its own array, with a length-1 batch axis by default,
    so ragged shapes coexist (``use_shared_mem`` is accepted and
    ignored)."""

    def __init__(self, expand=True, batch_axis=0, use_shared_mem=False):
        self._expand = expand
        self._batch_axis = batch_axis

    def __call__(self, data):
        out = []
        for sample in data:
            arr = onp.array(to_numpy(sample))
            if self._expand:
                arr = onp.expand_dims(arr, axis=self._batch_axis)
            out.append(arr)
        return out


class AsList:
    """The samples untouched, as a list."""

    def __call__(self, data):
        return list(data)
