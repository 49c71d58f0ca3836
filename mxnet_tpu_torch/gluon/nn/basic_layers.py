"""Basic layers of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``, ``Concatenate``, ``HybridConcatenate``,
``Dense``, ``Dropout``, ``Activation``, ``LeakyReLU``, ``PReLU``,
``ELU``, ``SELU``, ``GELU``, ``SiLU``, ``Swish``, ``Embedding``,
``Flatten``, ``Identity``, ``Lambda`` and ``HybridLambda``, on the port's
:class:`~..block.Block` and :class:`~..parameter.Parameter`. Parameter
names and layouts are the reference's (``Dense.weight`` is
(units, in_units)), and ``Dense`` without ``in_units`` completes its
weight's shape at the first forward.
"""
from __future__ import annotations

import math

import torch

from ... import initializer as init_mod
from ... import numpy as np
from ... import numpy_extension as npx
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Concatenate",
           "HybridConcatenate", "Dense", "Dropout", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "SiLU", "Swish",
           "Embedding", "Flatten", "Identity", "Lambda", "HybridLambda"]


class Sequential(Block):
    """Runs its children in order (reference basic_layers.py Sequential);
    children are named "0", "1", ..."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        return (x,) + args if args else x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        items = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*items[key])
            return net
        return items[key]


class HybridSequential(Sequential, HybridBlock):
    """Sequential of hybrid blocks (reference HybridSequential); after
    ``hybridize()`` it replays CUDA graphs as every HybridBlock of the
    port."""


class Concatenate(Sequential):
    """Runs every child on the same input and concatenates their outputs
    along ``axis`` (reference basic_layers.py:281)."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return np.concatenate([block(x) for block in self._modules.values()],
                              axis=self.axis)


class HybridConcatenate(HybridSequential):
    """Runs every child on the same input and concatenates their outputs
    along ``axis`` (reference basic_layers.py:293)."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    forward = Concatenate.forward


class Dense(HybridBlock):
    """Fully-connected layer: y = act(x @ W^T + b), W of shape
    (units, in_units) (reference basic_layers.py Dense). ``in_units=0``
    defers the weight's shape to the first forward: the product of the
    input's non-batch axes (``flatten=True``) or its last axis."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self.act = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(units,), dtype=dtype,
                               init=bias_initializer)
                     if use_bias else None)

    def forward(self, x):
        if not self.weight.shape_known:
            in_units = (math.prod(x.shape[1:]) if self._flatten
                        else x.shape[-1])
            self.weight.shape = (self._units, in_units)
            self.weight.finalize()
        out = npx.fully_connected(
            x, self.weight.data(),
            self.bias.data() if self.bias is not None else None,
            num_hidden=self._units, flatten=self._flatten,
            no_bias=self.bias is None)
        if self.act is not None:
            out = npx.activation(out, act_type=self.act)
        return out

    def extra_repr(self):
        return f"{self._units}, {self.weight.shape}, act={self.act}"


class Dropout(HybridBlock):
    """Zeroes activations with rate ``rate`` while
    :func:`~mxnet_tpu_torch.autograd.is_training` (inside
    ``autograd.record()``); identity otherwise. Draws from the
    generator of the input's device (:func:`~...ops.nn.generator`)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return npx.dropout(x, p=self._rate, axes=self._axes)

    def extra_repr(self):
        return f"p = {self._rate}, axes={self._axes}"


class Activation(HybridBlock):
    """Elementwise activation by name (reference Activation ->
    npx.activation)."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return npx.activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class LeakyReLU(HybridBlock):
    """``x`` if ``x >= 0`` else ``alpha * x`` (reference
    basic_layers.py:165)."""

    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope per channel, ``alpha`` of shape
    ``(in_channels,)`` (reference basic_layers.py:175)."""

    def __init__(self, alpha_initializer=init_mod.Constant(0.25),
                 in_channels=1):
        super().__init__()
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer)

    def forward(self, x):
        return npx.leaky_relu(x, gamma=self.alpha.data(), act_type="prelu")


class ELU(HybridBlock):
    """``x`` if ``x >= 0`` else ``alpha * (exp(x) - 1)`` (reference
    basic_layers.py:184)."""

    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Self-normalizing ELU (reference basic_layers.py:193)."""

    def forward(self, x):
        return npx.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """GELU, the erf form unless ``approximation="tanh"`` (reference
    basic_layers.py:199)."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        return npx.gelu(x, approximate=self._approx == "tanh")


class SiLU(HybridBlock):
    """``x * sigmoid(x)`` (reference basic_layers.py:208)."""

    def forward(self, x):
        return npx.activation(x, act_type="silu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference basic_layers.py:214)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class Embedding(HybridBlock):
    """Token embedding table (input_dim, output_dim) (reference
    basic_layers.py Embedding)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype, init=weight_initializer)

    def forward(self, x):
        return npx.embedding(x, self.weight.data(), self._input_dim,
                             self._output_dim)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class Flatten(HybridBlock):
    """Collapses every axis but the batch axis (reference
    basic_layers.py:143)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(HybridBlock):
    """Returns its input (reference basic_layers.py:275)."""

    def forward(self, x):
        return x


def _function(function):
    if isinstance(function, str):
        function = getattr(np, function, None) or getattr(npx, function)
    return function


class Lambda(Block):
    """Wraps a function (or the name of an ``mx.np``/``mx.npx``
    function) as a Block (reference Lambda)."""

    def __init__(self, function):
        super().__init__()
        self._func = _function(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Lambda as a HybridBlock (reference HybridLambda)."""

    def __init__(self, function):
        super().__init__()
        self._func = _function(function)

    def forward(self, *args):
        return self._func(*args)
