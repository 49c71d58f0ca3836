"""Normalization layers of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/norm_layers.py``): ``BatchNorm`` (parameters
``gamma``, ``beta``, ``running_mean`` and ``running_var``, through
:func:`~...numpy_extension.batch_norm`, the reference's arithmetic in
torch), ``SyncBatchNorm`` (``BatchNorm`` on one card) and
``BatchNormReLU``; ``LayerNorm`` (``gamma`` and ``beta``, through
:func:`~...ops.nn.layer_norm`, the K2 kernel on the card) and ``RMSNorm``
(``gamma``, through :func:`~...ops.nn.rms_norm`, the K2r kernel on the
card), ``GroupNorm`` and ``InstanceNorm`` (``gamma`` and ``beta`` per
channel of axis 1, the reference's arithmetic in torch). Without
``in_channels`` the parameters take the normalized axis's width at the
first forward. BatchNorm's running statistics are Parameters with
``grad_req="null"`` that a training forward updates in place (the
reference's aux states); the Trainer skips them.
"""
from __future__ import annotations

from ... import numpy_extension as npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["BatchNorm", "SyncBatchNorm", "BatchNormReLU", "LayerNorm",
           "RMSNorm", "GroupNorm", "InstanceNorm"]


def _finalize(x, axis, *params):
    for p in params:
        if not p.shape_known:
            p.shape = (x.shape[axis],)
            p.finalize()


class BatchNorm(HybridBlock):
    """Batch normalization over the channel ``axis`` with running
    statistics (reference norm_layers.py:19, Ioffe & Szegedy 2015):
    batch statistics while :func:`~mxnet_tpu_torch.autograd.is_training`
    (which moves the running ones, ``momentum`` the weight of the old),
    the running statistics otherwise or with ``use_global_stats``.
    ``scale=False`` fixes gamma at one, ``center=False`` beta at zero
    (neither then takes a gradient)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 dtype="float32"):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,) if in_channels else (0,)
        self.gamma = Parameter("gamma", shape=shape, dtype=dtype,
                               init=gamma_initializer,
                               allow_deferred_init=True,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=shape, dtype=dtype,
                              init=beta_initializer, allow_deferred_init=True,
                              differentiable=center)
        self.running_mean = Parameter("running_mean", shape=shape,
                                      dtype="float32",
                                      init=running_mean_initializer,
                                      allow_deferred_init=True,
                                      differentiable=False)
        self.running_var = Parameter("running_var", shape=shape,
                                     dtype="float32",
                                     init=running_variance_initializer,
                                     allow_deferred_init=True,
                                     differentiable=False)

    def forward(self, x):
        _finalize(x, self._axis, self.gamma, self.beta, self.running_mean,
                  self.running_var)
        return npx.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(),
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)

    def extra_repr(self):
        return (f"axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum}")


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference norm_layers.py:67); on one card
    it is BatchNorm, as in the reference."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class BatchNormReLU(BatchNorm):
    """BatchNorm followed by ReLU (reference norm_layers.py:173)."""

    def forward(self, x):
        return npx.activation(super().forward(x), act_type="relu")


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


class GroupNorm(HybridBlock):
    """Normalizes each sample's channel groups (reference
    norm_layers.py:107, Wu & He 2018): ``gamma`` and ``beta`` per
    channel of axis 1."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32"):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        shape = (in_channels,) if in_channels else (0,)
        self.gamma = Parameter("gamma", shape=shape, dtype=dtype,
                               init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=shape, dtype=dtype,
                              init=beta_initializer, allow_deferred_init=True)

    def forward(self, x):
        _finalize(x, 1, self.gamma, self.beta)
        return npx.group_norm(x, self.gamma.data(), self.beta.data(),
                              num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """Normalizes each sample's channels over the spatial axes
    (reference norm_layers.py:131, Ulyanov et al.): ``gamma`` and
    ``beta`` per channel of axis 1."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32"):
        super().__init__()
        self._epsilon = epsilon
        shape = (in_channels,) if in_channels else (0,)
        self.gamma = Parameter("gamma", shape=shape, dtype=dtype,
                               init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=shape, dtype=dtype,
                              init=beta_initializer, allow_deferred_init=True)

    def forward(self, x):
        _finalize(x, 1, self.gamma, self.beta)
        return npx.instance_norm(x, self.gamma.data(), self.beta.data(),
                                 eps=self._epsilon)
