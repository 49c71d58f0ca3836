"""Convolution and pooling layers of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D/2D/3D``, their
``Transpose`` forms, max, average and global pooling in 1, 2 and 3 D,
and ``ReflectionPad2D``, over :func:`~...numpy_extension.convolution`,
:func:`~...numpy_extension.deconvolution` and
:func:`~...numpy_extension.pooling`. Names and layouts are the
reference's: a convolution's ``weight`` is (channels, in_channels /
groups, *kernel) for channels-first layouts (torch's own), a transposed
one's (in_channels, channels / groups, *kernel). Without
``in_channels`` the weight's shape is completed at the first forward.
"""
from __future__ import annotations

import torch.nn.functional as F

from ... import numpy_extension as npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = [
    "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
    "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
    "ReflectionPad2D",
]


def _pair(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """N-D convolution or transposed convolution (reference
    conv_layers.py:26): ``weight`` and ``bias`` with a deferred
    ``in_channels``, an optional activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32", ndim=2,
                 transpose=False, output_padding=0):
        super().__init__()
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _pair(kernel_size, ndim)
        self._strides = _pair(strides, ndim)
        self._padding = _pair(padding, ndim)
        self._dilation = _pair(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._ndim = ndim
        self._transpose = transpose
        self._output_padding = _pair(output_padding, ndim)
        self.act = activation
        self.weight = Parameter("weight",
                                shape=self._weight_shape(in_channels),
                                dtype=dtype, init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(channels,), dtype=dtype,
                               init=bias_initializer)
                     if use_bias else None)

    def _weight_shape(self, in_ch):
        if self._transpose:
            return (in_ch, self._channels // self._groups) + self._kernel
        return (self._channels,
                in_ch // self._groups if in_ch else 0) + self._kernel

    def forward(self, x):
        if not self.weight.shape_known:
            axis = 1 if self._layout.startswith("NC") else self._ndim + 1
            self.weight.shape = self._weight_shape(x.shape[axis])
            self.weight.finalize()
        weight = self.weight.data()
        bias = self.bias.data() if self.bias is not None else None
        if self._transpose:
            out = npx.deconvolution(
                x, weight, bias, stride=self._strides, dilate=self._dilation,
                pad=self._padding, adj=self._output_padding,
                num_group=self._groups, no_bias=bias is None,
                layout=self._layout)
        else:
            out = npx.convolution(
                x, weight, bias, kernel=self._kernel, stride=self._strides,
                dilate=self._dilation, pad=self._padding,
                num_group=self._groups, no_bias=bias is None,
                layout=self._layout)
        if self.act is not None:
            out = npx.activation(out, act_type=self.act)
        return out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding}")


class Conv1D(_Conv):
    """1-D convolution over NCW input (reference Conv1D)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=1)


class Conv2D(_Conv):
    """2-D convolution over NCHW input (reference Conv2D); cuDNN on the
    card."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=2)


class Conv3D(_Conv):
    """3-D convolution over NCDHW input (reference Conv3D)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=3)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution (reference Conv1DTranspose)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=1,
                         transpose=True, output_padding=output_padding)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution (reference Conv2DTranspose)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=2,
                         transpose=True, output_padding=output_padding)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution (reference Conv3DTranspose)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=3,
                         transpose=True, output_padding=output_padding)


class _Pooling(HybridBlock):
    """Pooling over :func:`~...numpy_extension.pooling` (reference
    conv_layers.py:166): max or average, global or windowed, with
    ``ceil_mode`` and ``count_include_pad``."""

    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, count_include_pad=True, ceil_mode=False):
        super().__init__()
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
        self._global = global_pool
        self._type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad
        self._ceil_mode = ceil_mode

    def forward(self, x):
        return npx.pooling(
            x, kernel=self._pool_size, pool_type=self._type,
            stride=self._strides, pad=self._padding,
            global_pool=self._global,
            count_include_pad=self._count_include_pad, layout=self._layout,
            pooling_convention="full" if self._ceil_mode else "valid")

    def extra_repr(self):
        return (f"size={self._pool_size}, stride={self._strides}, "
                f"padding={self._padding}")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, 1, 0, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__(1, 1, 0, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__(1, 1, 0, True, "max", layout)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, 1, 0, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    """The mean over every spatial position, the classifier head's pool
    (reference GlobalAvgPool2D): (N, C, H, W) -> (N, C, 1, 1)."""

    def __init__(self, layout="NCHW"):
        super().__init__(1, 1, 0, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__(1, 1, 0, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflection-pads the two spatial axes of an NCHW tensor by
    ``padding`` on each side, the edge not repeated (reference
    conv_layers.py:273)."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = int(padding)

    def forward(self, x):
        p = self._padding
        return F.pad(x, (p, p, p, p), mode="reflect") if p else x

    def extra_repr(self):
        return f"padding={self._padding}"
