"""``mx.npx`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``): the neural-network ops the
Gluon layers call, each forwarding to :mod:`~mxnet_tpu_torch.ops.nn` as
the reference's ``_call`` forwards to its ``ops/nn.py``. Autograd is
torch's own, so there is no dispatch layer between. ``dropout`` reads
the training flag of :mod:`~mxnet_tpu_torch.autograd`, as the
reference's does.
"""
from __future__ import annotations

from ..autograd import is_training
from ..ops import nn as _nn

__all__ = ["fully_connected", "activation", "layer_norm", "rms_norm",
           "softmax", "log_softmax", "dropout", "embedding", "pick"]


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    return _nn.fully_connected(x, weight, None if no_bias else bias,
                               num_hidden=num_hidden, flatten=flatten,
                               no_bias=no_bias)


def activation(x, act_type="relu"):
    return _nn.activation(x, act_type)


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
