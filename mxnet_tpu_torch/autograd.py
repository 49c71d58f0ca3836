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
overwrites it. :func:`backward` gives the write semantics to the leaves
whose ``grad_req`` says "write" (Gluon parameters, and tensors given
``attach_grad``): it clears their ``.grad`` before it runs, so the
backward writes them anew. A leaf torch made (``requires_grad_()``)
accumulates, as in torch; :class:`~mxnet_tpu_torch.gluon.Trainer` sets
the gradients it applied to None after its update.

:func:`grad` returns gradients without touching ``.grad``
(``torch.autograd.grad``), with ``create_graph`` for higher orders.
:class:`Function` is the reference's user-defined differentiable
function, built on ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "Function"]


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


def train_mode():
    """Training mode on inside the scope; grad mode unchanged."""
    return _Scope(None, True)


def predict_mode():
    """Training mode off inside the scope; grad mode unchanged."""
    return _Scope(None, False)


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_record: bool) -> bool:
    """Turn recording (and torch's grad mode) on or off; returns the
    previous state."""
    prev = _state.recording
    _state.recording = bool(is_record)
    torch.set_grad_enabled(bool(is_record))
    return prev


def set_training(train: bool) -> bool:
    """Turn training mode on or off; returns the previous state."""
    prev = _state.training
    _state.training = bool(train)
    return prev


def _heads_and_grads(heads, head_grads):
    heads = [heads] if isinstance(heads, torch.Tensor) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    return heads, grads


def _write_leaves(heads):
    """The leaves the graph of ``heads`` reaches whose ``grad_req`` is
    "write" (a walk over ``grad_fn.next_functions`` to the
    AccumulateGrad nodes)."""
    out, seen = [], set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            if getattr(var, "_mx_grad_req", None) == "write":
                out.append(var)
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return out


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Back-propagate from ``heads`` (a tensor or a list of tensors) into
    the leaves' ``.grad``. A head without a head gradient takes ones of
    its shape, whatever its shape. Leaves whose ``grad_req`` is "write"
    get this backward's gradient in place of what ``.grad`` held."""
    heads, grads = _heads_and_grads(heads, head_grads)
    for leaf in _write_leaves(heads):
        leaf.grad = None
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (a tensor or
    a list), returned instead of written to ``.grad`` (reference
    ``autograd.py:271``). ``create_graph=True`` records the gradient
    computation, so the result can be differentiated again."""
    heads, grads = _heads_and_grads(heads, head_grads)
    single = isinstance(variables, torch.Tensor)
    variables = [variables] if single else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    if not any(h.requires_grad for h in heads):
        raise MXNetError("autograd.grad: the heads were not recorded from "
                         "the variables (no graph)")
    with torch.enable_grad() if create_graph else torch.no_grad():
        out = torch.autograd.grad(heads, variables, grads,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [torch.zeros_like(v) if g is None else g
           for v, g in zip(variables, out)]
    return out[0] if single else out


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function` object's forward and backward."""

    @staticmethod
    def forward(ctx, func, *inputs):
        ctx.func = func
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in inputs]
        with _Scope(False, None):
            out = func.forward(*inputs)
        ctx.single = isinstance(out, torch.Tensor)
        return out

    @staticmethod
    def backward(ctx, *out_grads):
        with _Scope(False, None):
            in_grads = ctx.func.backward(*out_grads)
        if isinstance(in_grads, torch.Tensor):
            in_grads = (in_grads,)
        in_grads = iter(in_grads)
        return (None, *(next(in_grads, None) if t else None
                        for t in ctx.is_tensor))


class Function:
    """User-defined differentiable function (reference autograd.py:388),
    on ``torch.autograd.Function``. Subclass it and write ``forward``
    and ``backward`` with tensor ops; ``backward`` gets one gradient per
    output and returns one per tensor input::

        class sigmoid(Function):
            def forward(self, x):
                y = 1 / (1 + torch.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    Call an instance on tensors: ``y = sigmoid()(x)``. Both methods run
    with recording paused."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        return _Bridge.apply(self, *inputs)
