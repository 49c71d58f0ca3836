"""Normalization layers of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/norm_layers.py``): ``LayerNorm`` (parameters
``gamma`` and ``beta``, through :func:`~...ops.nn.layer_norm`, the K2
kernel on the card) and ``RMSNorm`` (``gamma``, through
:func:`~...ops.nn.rms_norm`, the K2r kernel on the card). Without
``in_channels`` the parameters take the normalized axis's width at the
first forward. ``BatchNorm``, ``GroupNorm`` and ``InstanceNorm`` are not
ported yet.
"""
from __future__ import annotations

from ... import numpy_extension as npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["LayerNorm", "RMSNorm"]


def _finalize(x, axis, *params):
    for p in params:
        if not p.shape_known:
            p.shape = (x.shape[axis],)
            p.finalize()


class LayerNorm(HybridBlock):
    """Normalizes over ``axis`` with learned gain ``gamma`` and bias
    ``beta`` (Ba et al. 2016; reference LayerNorm)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        shape = (in_channels,) if in_channels else (0,)
        self.gamma = Parameter("gamma", shape=shape, dtype=dtype,
                               init=gamma_initializer,
                               allow_deferred_init=True,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=shape, dtype=dtype,
                              init=beta_initializer, allow_deferred_init=True,
                              differentiable=center)

    def forward(self, x):
        _finalize(x, self._axis, self.gamma, self.beta)
        return npx.layer_norm(x, self.gamma.data(), self.beta.data(),
                              axis=self._axis, eps=self._epsilon)

    def extra_repr(self):
        return f"axis={self._axis}, eps={self._epsilon}"


class RMSNorm(HybridBlock):
    """Root-mean-square normalization with a learned gain ``gamma``
    (the JAX package's modern-transformer norm; no reference MXNet
    counterpart)."""

    def __init__(self, axis=-1, epsilon=1e-6, gamma_initializer="ones",
                 in_channels=0, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        shape = (in_channels,) if in_channels else (0,)
        self.gamma = Parameter("gamma", shape=shape, dtype=dtype,
                               init=gamma_initializer,
                               allow_deferred_init=True)

    def forward(self, x):
        _finalize(x, self._axis, self.gamma)
        return npx.rms_norm(x, self.gamma.data(), axis=self._axis,
                            eps=self._epsilon)

    def extra_repr(self):
        return f"axis={self._axis}, eps={self._epsilon}"
