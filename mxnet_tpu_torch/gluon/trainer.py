"""Trainer of the PyTorch port (counterpart of
``mxnet_tpu/gluon/trainer.py``): applies an optimizer to a set of
parameters after a backward.

``step(batch_size)`` sets ``rescale_grad = 1 / batch_size`` (times the
optimizer's own scale) and updates every parameter in place from its
``.grad``. Then it sets the ``.grad`` of every parameter whose
``grad_req`` is "write" to None: torch adds a backward's gradients to a
``.grad`` that holds a tensor, where the reference overwrites, so
clearing them makes the next backward write fresh gradients. After
``step``, such a ``.grad`` reads None; a second ``step`` with no
backward between raises. ``grad_req="add"`` gradients are kept (the
caller zeroes them with ``zero_grad``).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``: ``params`` is
    ``net.collect_params()`` (name -> Gluon
    :class:`~.parameter.Parameter`, deferred ones included: they are read
    at each step) or a name -> ``nn.Parameter`` dict
    (``dict(net.named_parameters())``); ``optimizer`` a registered name
    or an :class:`~mxnet_tpu_torch.optimizer.Optimizer`. As in the
    reference, the Trainer gives the optimizer the parameters' names
    (``idx2name``) and nothing else: a Parameter's ``lr_mult`` and
    ``wd_mult`` do not reach it, and per-parameter multipliers are set on
    the optimizer by name (``set_lr_mult``, ``set_wd_mult``)."""

    def __init__(self, params, optimizer, optimizer_params=None):
        if not isinstance(params, dict):
            raise MXNetError("params must be a name -> Parameter dict")
        self._param_names = list(params)
        self._params: List[Parameter] = []
        for name, p in params.items():
            if isinstance(p, torch.nn.Parameter):
                p = Parameter._of_tensor(name, p)
            elif not isinstance(p, Parameter):
                raise MXNetError(f"{name}: not a Parameter: {type(p)}")
            self._params.append(p)
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._optimizer.idx2name = dict(enumerate(self._param_names))
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, tuple] = {}

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every trainable parameter from ``.grad / batch_size``,
        then clear the gradients."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        live = [(i, p.data()) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        stale = [self._param_names[i] for i, w in live if w.grad is None]
        if stale and not ignore_stale_grad:
            raise MXNetError(
                f"no gradient for {stale[:3]}{'...' if len(stale) > 3 else ''}"
                " since the last step: run backward first, or pass "
                "ignore_stale_grad=True")
        for i, w in live:
            if w.grad is None:
                continue
            if i not in self._states:
                self._states[i] = opt.create_state(i, w)
            opt.update(i, w, w.grad, self._states[i])
            if self._params[i].grad_req == "write":
                w.grad = None
