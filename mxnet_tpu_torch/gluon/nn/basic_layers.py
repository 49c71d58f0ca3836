"""Basic layers of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Dense``, ``Embedding`` and
``Dropout`` as ``nn.Module``s. Parameter names and layouts are the
reference's (``Dense.weight`` is (out, in)), so a state dict carries the
reference's ``collect_params()`` names.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import nn as F

__all__ = ["Dense", "Embedding", "Dropout"]


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


class Dense(nn.Module):
    """Fully-connected layer: y = act(x @ W^T + b), W of shape
    (units, in_units). ``in_units`` must be given (no deferred shape
    inference in the port). Weights start normal(0, 0.02) from torch's
    default generator, biases at zero."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", in_units=0, device=None):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense needs in_units > 0 in the port")
        self._units = units
        self._flatten = flatten
        self.act = activation
        kw = {"dtype": _dtype(dtype), "device": device}
        self.weight = nn.Parameter(
            torch.empty((units, in_units), **kw).normal_(0.0, 0.02))
        self.bias = (nn.Parameter(torch.zeros((units,), **kw))
                     if use_bias else None)

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias,
                                num_hidden=self._units, flatten=self._flatten,
                                no_bias=self.bias is None)
        if self.act is not None:
            out = F.activation(out, act_type=self.act)
        return out


class Embedding(nn.Module):
    """Token embedding table (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim, dtype="float32", device=None):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = nn.Parameter(
            torch.empty((input_dim, output_dim), dtype=_dtype(dtype),
                        device=device).normal_(0.0, 0.02))

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """Drops activations with rate ``rate`` in training mode; identity at
    inference, which is all the serving slice runs."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        if not self.training or not self._rate:
            return x
        return torch.nn.functional.dropout(x, p=self._rate, training=True)
