"""Gluon Block and HybridBlock of the PyTorch port (counterpart of
``mxnet_tpu/gluon/block.py``).

A :class:`Block` is a ``torch.nn.Module``. Assigning a Gluon
:class:`~.parameter.Parameter` to an attribute registers it (``_reg_params``)
and registers its tensor with the module under the same name, so
``net.weight`` is the Gluon Parameter while ``state_dict()``,
``named_parameters()`` and ``load_state_dict()`` see the tensor; child
blocks register as torch submodules. So :meth:`Block.collect_params`'
dotted names are ``state_dict()``'s keys, and they equal the JAX
package's names for the same net. A ``torch.nn.Parameter`` assigned the
torch way is collected too, under a Parameter made over it.

``initialize`` sets every parameter's initializer and device (default
``Uniform(0.07)`` on ``gpu(0)``); parameters whose shape has zeros are
made at the first forward, when the layer knows its input. Forward
hooks are torch's (``hook(block, inputs, output)``, as the reference's).
``hybridize()`` is accepted and the block runs eagerly: capturing the
forward in a CUDA graph is later work (``ROADMAP.md``); ``export``,
``SymbolBlock`` and ``optimize_for`` are not ported.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from .. import initializer as init_mod
from .. import serialization
from .parameter import Parameter

__all__ = ["Block", "HybridBlock"]


class _HookHandle:
    """The reference's hook handle (``detach``) over torch's."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class Block(nn.Module):
    """Base model component (reference block.py:251), an ``nn.Module``."""

    def __init__(self):
        super().__init__()
        self._reg_params: Dict[str, Parameter] = {}

    # -- attribute registration -----------------------------------------------
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            if reg is None:
                raise MXNetError("call Block.__init__() before assigning "
                                 "parameters")
            if value._name in ("weight", "param", "") or value._name is None:
                value._name = name
            self.register_parameter(name, value._var)
            object.__setattr__(self, name, value)
            reg[name] = value
            return
        if reg is not None and name in reg:
            del reg[name]
            self.__dict__.pop(name, None)
            self._parameters.pop(name, None)
        super().__setattr__(name, value)

    def register_child(self, block: nn.Module, name: Optional[str] = None):
        self.add_module(name or str(len(self._modules)), block)

    # -- parameter collection -------------------------------------------------
    def _own_params(self):
        """(name, Parameter) of this block's own tensors, in registration
        order; a torch-registered ``nn.Parameter`` gets a Parameter made
        over it."""
        for name, var in self._parameters.items():
            if var is None:
                continue
            p = self._reg_params.get(name)
            if p is None or p._var is not var:
                p = self._reg_params[name] = Parameter._of_tensor(name, var)
            yield name, p

    def _collect(self, out: Dict[str, Parameter], prefix: str):
        for name, p in self._own_params():
            out[prefix + name] = p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                child._collect(out, prefix + cname + ".")
            elif child is not None:
                for n, var in child.named_parameters(
                        prefix=prefix + cname, remove_duplicate=False):
                    out[n] = Parameter._of_tensor(n, var)

    def collect_params(self, select: Optional[str] = None
                       ) -> Dict[str, Parameter]:
        """Dotted name -> Parameter of this block and its children (the
        keys of ``state_dict()``); ``select`` is a regular expression the
        names must match."""
        out: Dict[str, Parameter] = {}
        self._collect(out, "")
        if select is not None:
            pat = re.compile(select)
            out = {k: v for k, v in out.items() if pat.search(k)}
        return out

    @property
    def params(self) -> Dict[str, Parameter]:
        return dict(self._own_params())

    # -- lifecycle ----------------------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``device`` (default ``gpu(0)``)
        with its own initializer, else ``init``, else ``Uniform(0.07)``;
        deferred shapes are initialized at the first forward."""
        dev = resolve_device(device if device is not None else ctx)
        default = init or init_mod.Uniform(0.07)
        for name, p in self.collect_params().items():
            p._name = name   # fully qualified, for the initializer's rules
            p.initialize(init=p.init, device=dev, default_init=default,
                         force_reinit=force_reinit)
        return self

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        self._dtype = dtype
        return self

    def zero_grad(self, set_to_none: bool = False):
        """Set every parameter's gradient to zeros (the reference's
        ``zero_grad``; ``set_to_none=True`` drops them, as torch's)."""
        for p in self.collect_params().values():
            if set_to_none and p.initialized:
                p._var.grad = None
            else:
                p.zero_grad()

    def hybridize(self, active: bool = True, **kwargs):
        """Accepted for the reference's API; the block runs eagerly."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    # -- checkpointing (reference block.py:440 / :496) -------------------------
    def save_parameters(self, filename: str, deduplicate: bool = False):
        """Write every initialized parameter to a ``.params`` file (the
        reference's format, loadable by the JAX package)."""
        serialization.save_params(filename, {
            name: p.data() for name, p in self.collect_params().items()
            if p.initialized})

    def load_parameters(self, filename: str, device=None, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current"):
        """Load a ``.params`` file (written by either package) into the
        parameters, in their dtypes. An initialized parameter keeps its
        device; an uninitialized one is made on ``device``, else its
        initialize() device, else ``gpu(0)``."""
        self.load_dict(serialization.load_params(filename),
                       device if device is not None else ctx,
                       allow_missing, ignore_extra, what=filename)

    def load_dict(self, param_dict, device=None, allow_missing=False,
                  ignore_extra=False, what="dict"):
        params = self.collect_params()
        for name, p in params.items():
            if name in param_dict:
                p.set_data(param_dict[name], device=device)
            elif not allow_missing:
                raise MXNetError(f"Parameter {name} missing in {what}")
        extra = set(param_dict) - set(params)
        if extra and not ignore_extra:
            raise MXNetError(f"{what} has extra parameters {sorted(extra)}")

    # -- hooks --------------------------------------------------------------------
    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after each forward."""
        return _HookHandle(super().register_forward_hook(hook))

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each forward; it may return new
        inputs."""
        return _HookHandle(super().register_forward_pre_hook(hook))

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose forward the reference traces into one program
    (reference block.py:854). Here ``hybridize()`` is accepted and the
    forward runs eagerly, op by op."""
