"""``mx.npx`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``): the neural-network ops the
Gluon layers call, each forwarding to :mod:`~mxnet_tpu_torch.ops.nn` as
the reference's ``_call`` forwards to its ``ops/nn.py``. Autograd is
torch's own, so there is no dispatch layer between. ``dropout`` reads
the training flag of :mod:`~mxnet_tpu_torch.autograd`, as the
reference's does.
"""
from __future__ import annotations

import torch

from ..autograd import is_training
from ..ops import nn as _nn

__all__ = ["fully_connected", "activation", "convolution", "deconvolution",
           "pooling", "batch_norm", "layer_norm", "rms_norm", "softmax",
           "log_softmax", "dropout", "embedding", "pick"]


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    return _nn.fully_connected(x, weight, None if no_bias else bias,
                               num_hidden=num_hidden, flatten=flatten,
                               no_bias=no_bias)


def activation(x, act_type="relu"):
    return _nn.activation(x, act_type)


def convolution(x, weight, bias=None, kernel=None, stride=1, dilate=1, pad=0,
                num_filter=0, num_group=1, no_bias=False, layout="NCHW"):
    return _nn.convolution(x, weight, None if no_bias else bias,
                           stride=stride, dilate=dilate, pad=pad,
                           num_group=num_group, layout=layout)


def deconvolution(x, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_filter=0, num_group=1, no_bias=False, layout="NCHW"):
    return _nn.deconvolution(x, weight, None if no_bias else bias,
                             stride=stride, dilate=dilate, pad=pad, adj=adj,
                             num_group=num_group, layout=layout)


def pooling(x, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True, layout="NCHW",
            pooling_convention="valid"):
    """``pooling_convention="full"`` is ``ceil_mode``."""
    return _nn.pooling(x, kernel, pool_type, stride, pad, global_pool,
                       count_include_pad, layout,
                       ceil_mode=pooling_convention == "full")


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    """BatchNorm in training mode while
    :func:`~mxnet_tpu_torch.autograd.is_training` (inside
    ``autograd.record()``), with the moving statistics otherwise. In
    training, and not with ``use_global_stats``, the new statistics are
    written into ``running_mean`` and ``running_var`` in place, as the
    reference's aux states. ``output_mean_var=True`` returns ``(out,
    new_mean, new_var)``."""
    training = is_training()
    out, new_mean, new_var = _nn.batch_norm(
        x, gamma, beta, running_mean, running_var, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, training=training, axis=axis)
    if training and not use_global_stats:
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    if output_mean_var:
        return out, new_mean, new_var
    return out


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    return _nn.layer_norm(x, gamma, beta, axis=axis, eps=eps)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    return _nn.rms_norm(x, gamma, axis=axis, eps=eps)


def softmax(x, axis=-1):
    return _nn.softmax(x, axis=axis)


def log_softmax(x, axis=-1):
    return _nn.log_softmax(x, axis=axis)


def dropout(x, p=0.5, axes=None, mode="training"):
    """Dropout while :func:`~mxnet_tpu_torch.autograd.is_training` (or
    always, with ``mode="always"``); the identity otherwise."""
    training = is_training() or mode == "always"
    return _nn.dropout(x, p=p, training=training, axes=axes or ())


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Row gather; ``sparse_grad`` is accepted and the gradient is dense
    (a row-sparse gradient is not ported)."""
    return _nn.embedding(data, weight)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    return _nn.pick(data, index, axis=axis, keepdims=keepdims)
