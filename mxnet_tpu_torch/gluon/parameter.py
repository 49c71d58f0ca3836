"""Gluon Parameter of the PyTorch port (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` holds one ``torch.nn.Parameter`` (``_var``) for its
whole life. Until its shape and device are known the tensor is a
``torch.nn.parameter.UninitializedParameter``, torch's own idiom for a
deferred shape; :meth:`Parameter.initialize` (or the first forward,
through :meth:`Parameter.finalize`) materializes it in place, so a
:class:`~.block.Block` that registered it, and a Trainer that holds it,
see the same tensor before and after. ``set_data``, ``cast`` and device
moves write into it in place as well.

The deferred-init contract is the reference's: a shape with 0 entries
is completed when a layer sets it at its first forward; reading data
before then raises :class:`DeferredInitializationError`.

Inside :func:`substituted` (what ``Block.functionalize``'s ``fn`` runs
its forward in) :meth:`Parameter.data` returns the caller's tensor
instead, on that thread only, so every layer that reads its parameters
through ``data()`` computes with the caller's tensors.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch.nn.parameter import UninitializedParameter

from ..base import MXNetError, dtype_from_any
from ..context import resolve_device
from ..ndarray.ndarray import GRAD_REQS, from_numpy
from .. import initializer as init_mod

__all__ = ["Parameter", "Constant", "DeferredInitializationError"]


class _Substitution(threading.local):
    tensors = None          # {Parameter: tensor} inside substituted()


_subst = _Substitution()


@contextmanager
def substituted(pairs):
    """:meth:`Parameter.data` returns ``tensor`` for each ``(Parameter,
    tensor)`` of ``pairs`` inside the scope, on this thread (the
    reference's ``substitute_params``)."""
    was = _subst.tensors
    _subst.tensors = {**(was or {}), **dict(pairs)}
    try:
        yield
    finally:
        _subst.tensors = was


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its deferred shape/init completed."""


def _shape_known(shape) -> bool:
    return shape is not None and all(int(s) > 0 for s in shape)


def _as_tensor(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.detach()
    return from_numpy(data)


class Parameter:
    """A trainable tensor with its initializer, ``grad_req`` and
    learning-rate and weight-decay multipliers."""

    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if isinstance(shape, int):
            shape = (shape,)
        self._name = name
        self._shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dtype = dtype_from_any(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        req = grad_req if differentiable else "null"
        if req not in GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {GRAD_REQS}")
        self._var = UninitializedParameter(requires_grad=req != "null",
                                           dtype=self.dtype)
        self._var._mx_grad_req = req
        self._deferred_init = None      # (initializer, device)
        self._ready = False             # _var holds initialized data

    @classmethod
    def _of_tensor(cls, name, var: torch.nn.Parameter) -> "Parameter":
        """A Parameter over an existing, initialized ``nn.Parameter`` (one
        a module registered the torch way)."""
        p = cls.__new__(cls)
        p._name = name
        p._shape = tuple(var.shape)
        p.dtype = var.dtype
        p.lr_mult = p.wd_mult = 1.0
        p.init = None
        p.allow_deferred_init = False
        p._differentiable = var.requires_grad
        p._var = var
        if getattr(var, "_mx_grad_req", None) is None:
            var._mx_grad_req = "write" if var.requires_grad else "null"
        p._deferred_init = None
        p._ready = True
        return p

    # -- naming and shape ----------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(s) for s in new_shape)
        if self._shape is not None and not (
                len(self._shape) == len(new_shape)
                and all(a == b or a <= 0
                        for a, b in zip(self._shape, new_shape))):
            raise MXNetError(f"cannot update shape of {self.name} from "
                             f"{self._shape} to {new_shape}")
        self._shape = new_shape

    @property
    def shape_known(self) -> bool:
        return _shape_known(self._shape)

    @property
    def grad_req(self) -> str:
        return self._var._mx_grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {GRAD_REQS}")
        if not self._differentiable:
            req = "null"
        self._var.requires_grad = req != "null"
        self._var._mx_grad_req = req
        if req == "null" and self._ready:
            self._var.grad = None

    # -- initialization ------------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None,
                   default_init=None, force_reinit=False):
        """Set the initializer and device; the data is made now when the
        shape is known, else at :meth:`finalize` (the first forward).
        An initialized parameter is left alone unless ``force_reinit``."""
        if self._ready and not force_reinit:
            return
        device = device if device is not None else ctx
        if device is None and self._ready:
            dev = self._var.device
        else:
            dev = resolve_device(device)
        self._deferred_init = (
            init or self.init or default_init or init_mod.Uniform(0.07), dev)
        if self.shape_known:
            self._finish_deferred_init()

    def _materialize(self, dev):
        if self._ready:
            if self._var.device != dev or tuple(self._var.shape) != self._shape:
                self._var.data = torch.empty(self._shape, dtype=self.dtype,
                                             device=dev)
        else:
            self._var.materialize(self._shape, device=dev, dtype=self.dtype)
            self._ready = True
        self._var.grad = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self.shape_known:
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has unknown shape {self._shape} "
                    "and allow_deferred_init=False")
            return
        initializer, dev = self._deferred_init
        self._materialize(dev)
        init_mod.create(initializer).init_array(self._name, self._var)
        self._deferred_init = None

    def finalize(self):
        """Complete a deferred initialization once the shape is known
        (layers call it at their first forward)."""
        if not self._ready and self._deferred_init is not None:
            self._finish_deferred_init()

    # -- access ----------------------------------------------------------------
    def _check_initialized(self):
        if self._ready:
            return
        if self._deferred_init is not None:
            if self.shape_known:
                self._finish_deferred_init()
                return
            raise DeferredInitializationError(
                f"Parameter {self.name} deferred; run a forward pass or set "
                "its shape")
        raise MXNetError(f"Parameter {self.name} has not been initialized; "
                         "call .initialize()")

    def data(self, ctx=None) -> torch.nn.Parameter:
        """The parameter's tensor (a ``torch.nn.Parameter``), or the one
        :func:`substituted` gives it."""
        if _subst.tensors is not None and self in _subst.tensors:
            return _subst.tensors[self]
        if not self._ready:
            self._check_initialized()
        return self._var

    @property
    def initialized(self) -> bool:
        return self._ready

    def _device_for_data(self, device):
        if device is not None:
            return resolve_device(device)
        if self._ready:
            return self._var.device
        if self._deferred_init is not None:
            return self._deferred_init[1]
        return resolve_device(None)

    def set_data(self, data, device=None):
        """Write ``data`` (a tensor or numpy array) into the parameter, in
        its dtype. An uninitialized parameter takes data's shape and is
        made on ``device``, else its initialize() device, else the
        default device (``gpu(0)``: host data does not keep it on the
        CPU)."""
        dev = self._device_for_data(device)
        t = _as_tensor(data)
        if not self._ready:
            self.shape = tuple(t.shape)
            self._materialize(dev)
            self._deferred_init = None
        elif tuple(t.shape) != self._shape:
            raise MXNetError(f"shape mismatch setting {self.name}: "
                             f"{tuple(t.shape)} vs {self._shape}")
        with torch.no_grad():
            self._var.copy_(t)

    def grad(self, ctx=None) -> torch.Tensor:
        """The gradient (zeros before the first backward)."""
        self._check_initialized()
        if self.grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        g = self._var.grad
        return torch.zeros_like(self._var) if g is None else g

    def zero_grad(self):
        """Set the gradient to zeros."""
        if self._ready and self._var.grad is not None:
            self._var.grad.zero_()

    def cast(self, dtype):
        """Cast the data to ``dtype`` in place (the gradient is
        dropped)."""
        self.dtype = dtype_from_any(dtype)
        if self._ready:
            self._var.data = self._var.data.to(self.dtype)
            self._var.grad = None

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={str(self.dtype).replace('torch.', '')})")


class Constant(Parameter):
    """A non-trainable constant parameter (reference
    gluon/parameter.py Constant)."""

    def __init__(self, value, name="const"):
        value = _as_tensor(value)
        super().__init__(name=name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, differentiable=False)
        self._value = value
        self.init = init_mod.Constant(value)

    def initialize(self, init=None, device=None, ctx=None,
                   default_init=None, force_reinit=False):
        if self._ready and not force_reinit:
            return
        dev = resolve_device(device if device is not None else ctx)
        self._materialize(dev)
        with torch.no_grad():
            self._var.copy_(self._value)
