"""Autograd scopes of the PyTorch port (counterpart of
``mxnet_tpu/autograd.py``) over ``torch.autograd``.

``record()`` turns grad mode on and training mode on, ``pause()`` turns
both off; the training flag is what ``Dropout`` and attention dropout
read (:func:`is_training`). :func:`backward` runs
``torch.autograd.backward`` with ones as the head gradient of every head
that has none, scalar or not, as the reference does; a bare torch
``loss.backward()`` refuses a non-scalar head.

Gradients land in each leaf's ``.grad``. torch adds to a ``.grad`` that
already holds a tensor, where the reference (``grad_req="write"``)
overwrites it; :class:`~mxnet_tpu_torch.gluon.Trainer` gives the write
semantics by setting every ``.grad`` to None after its update, so the
next backward writes fresh gradients.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["record", "pause", "is_recording", "is_training", "backward"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


class _Scope:
    def __init__(self, record: Optional[bool], train: Optional[bool]):
        self._record, self._train = record, train

    def __enter__(self):
        self._prev = (_state.recording, _state.training,
                      torch.is_grad_enabled())
        if self._record is not None:
            _state.recording = self._record
            torch.set_grad_enabled(self._record)
        if self._train is not None:
            _state.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training, grad = self._prev
        torch.set_grad_enabled(grad)
        return False


def record(train_mode: bool = True):
    """``with autograd.record():`` — grad mode on; training mode on
    unless ``train_mode=False``."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False):
    """Grad mode off inside the scope (training mode off by default)."""
    return _Scope(False, train_mode)


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def backward(heads, head_grads=None):
    """Back-propagate from ``heads`` (a tensor or a list of tensors) into
    the leaves' ``.grad``. A head without a head gradient takes ones of
    its shape, whatever its shape."""
    heads = [heads] if isinstance(heads, torch.Tensor) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    torch.autograd.backward(heads, grads)
