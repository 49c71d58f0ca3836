"""Normalization layers of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/norm_layers.py``): ``LayerNorm`` with parameters
named ``gamma`` and ``beta``, through :func:`~..ops.nn.layer_norm`
(the K2 kernel on the card)."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import nn as F
from .basic_layers import _dtype

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """Normalizes over ``axis`` with learned gain ``gamma`` and bias
    ``beta`` (Ba et al. 2016). ``in_channels`` must be given."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, dtype="float32", device=None):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm needs in_channels > 0 in the port")
        self._axis = axis
        self._epsilon = epsilon
        kw = {"dtype": _dtype(dtype), "device": device}
        self.gamma = nn.Parameter(torch.ones((in_channels,), **kw),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros((in_channels,), **kw),
                                 requires_grad=center)

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._epsilon)
