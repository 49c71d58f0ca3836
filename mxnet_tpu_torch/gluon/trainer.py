"""Trainer of the PyTorch port (counterpart of
``mxnet_tpu/gluon/trainer.py``): applies an optimizer to a set of
parameters after a backward.

``step(batch_size)`` sets ``rescale_grad = 1 / batch_size`` (times the
optimizer's own scale) and updates every parameter in place from its
``.grad``. Then it sets every ``.grad`` to None: torch adds a backward's
gradients to a ``.grad`` that holds a tensor, where the reference
(``grad_req="write"``) overwrites, so clearing them makes the next
backward write fresh gradients. After ``step``, ``.grad`` reads None; a
second ``step`` with no backward between raises.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError

__all__ = ["Trainer"]


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``: ``params`` is a
    name -> ``nn.Parameter`` dict (``dict(net.named_parameters())``);
    ``optimizer`` a registered name or an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer`."""

    def __init__(self, params, optimizer, optimizer_params=None):
        if not isinstance(params, dict):
            raise MXNetError("params must be a name -> Parameter dict")
        self._param_names = list(params)
        self._params: List[torch.nn.Parameter] = list(params.values())
        for name, p in zip(self._param_names, self._params):
            if not isinstance(p, torch.nn.Parameter):
                raise MXNetError(f"{name}: not a Parameter: {type(p)}")
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._optimizer.idx2name = dict(enumerate(self._param_names))
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, tuple] = {}

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
        live = [i for i, p in enumerate(self._params) if p.requires_grad]
        stale = [self._param_names[i] for i in live
                 if self._params[i].grad is None]
        if stale and not ignore_stale_grad:
            raise MXNetError(
                f"no gradient for {stale[:3]}{'...' if len(stale) > 3 else ''}"
                " since the last step: run backward first, or pass "
                "ignore_stale_grad=True")
        for i in live:
            p = self._params[i]
            if p.grad is None:
                continue
            if i not in self._states:
                self._states[i] = opt.create_state(i, p)
            opt.update(i, p, p.grad, self._states[i])
            p.grad = None
