"""Optimizers of the PyTorch port (counterpart of
``mxnet_tpu/optimizer/optimizer.py``), limited to what the training
slice runs: the ``Optimizer`` base (learning rate, weight decay,
``rescale_grad``, ``clip_gradient``, per-parameter lr/wd multipliers),
the registry and ``SGD``, ``Adam`` and ``AdamW``.

The update rules are the reference's, written out in torch (not
``torch.optim``, whose Adam places epsilon inside the bias correction).
Unlike the reference's pure rules, these update the weight and the
state tensors in place, so a step allocates no second copy of them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "Adam", "AdamW"]

_registry: Dict[str, type] = {}


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    """Instantiate a registered optimizer by (case-insensitive) name."""
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _registry[name.lower()]
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_registry)}") from None
    return klass(**kwargs)


class Optimizer:
    """Base optimizer. :meth:`update` applies the rule of
    :meth:`update_step` to one parameter: the gradient is scaled by
    ``rescale_grad`` and clipped to ``clip_gradient``, and the learning
    rate and weight decay carry the parameter's multipliers
    (``set_lr_mult`` / ``set_wd_mult``, keyed by index or by name)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None):
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _mult(self, table, index):
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index) -> float:
        return self.learning_rate * self._mult(self.lr_mult, index)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(self.wd_mult, index)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def create_state(self, index, weight) -> Tuple:
        return ()

    def update_step(self, weight, grad, state: Tuple, lr, wd, t: int):
        """Update ``weight`` and ``state`` in place from the scaled and
        clipped ``grad``."""
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        """One parameter's update, in place (``weight`` a tensor or an
        ``nn.Parameter``)."""
        self._update_count(index)
        with torch.no_grad():
            g = grad * self.rescale_grad
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            self.update_step(weight, g, state, self._get_lr(index),
                             self._get_wd(index),
                             self._index_update_count[index])

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay:
    ``mom = momentum * mom - lr * (g + wd * w); w += mom``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(weight, memory_format=torch.contiguous_format),)

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        if self.momentum == 0.0:
            w.sub_(lr * g)
            return
        (mom,) = state
        mom.mul_(self.momentum).sub_(lr * g)
        w.add_(mom)


@register
class Adam(Optimizer):
    """Adam: ``w -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``
    with weight decay added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(
            weight, memory_format=torch.contiguous_format) for _ in range(2))

    def _moments(self, g, state):
        m, v = state
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        return m, v

    def update_step(self, w, g, state, lr, wd, t):
        if wd:
            g = g + wd * w
        m, v = self._moments(g, state)
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        w.sub_(lr_t * m / (v.sqrt() + self.epsilon))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: ``w -= lr_t * m / (sqrt(v) + eps)
    + lr * wd * w``."""

    def update_step(self, w, g, state, lr, wd, t):
        m, v = self._moments(g, state)
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        decay = lr * wd * w
        w.sub_(lr_t * m / (v.sqrt() + self.epsilon)).sub_(decay)
