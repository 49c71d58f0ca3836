"""``gluon.contrib.cnn`` of the PyTorch port (counterpart of
``mxnet_tpu/gluon/contrib/cnn/__init__.py``): the
``DeformableConvolution`` and ``ModulatedDeformableConvolution`` layers.

The reference's contract: the offsets (and the DCNv2 mask) come from an
inner regular convolution whose weight and bias start at zero, so the
layer starts equal to a plain convolution and learns its deformation
field. ``in_channels`` may be left to the first forward, for both the
inner convolution and the layer's own weight. The sampling is
:func:`~mxnet_tpu_torch.ops.contrib.deformable_convolution`. Parameter
names are the reference's (``offset_weight``, ``offset_bias``,
``weight``, ``bias``), so ``convert.from_jax_params`` carries them.
"""
from __future__ import annotations

from .... import numpy_extension as npx
from ...block import HybridBlock
from ...parameter import Parameter

__all__ = ["DeformableConvolution", "ModulatedDeformableConvolution"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class DeformableConvolution(HybridBlock):
    """DCNv1 layer (reference conv_layers.py:29)."""

    _modulated = False

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 dtype="float32"):
        super().__init__()
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self._ndg = num_deformable_group
        self._act = activation
        kh, kw = self._kernel
        self._off_ch = (3 if self._modulated else 2) * kh * kw \
            * num_deformable_group
        self.offset_weight = Parameter(
            "offset_weight", shape=(self._off_ch, in_channels, kh, kw),
            dtype=dtype, init=offset_weight_initializer,
            allow_deferred_init=True)
        self.offset_bias = (
            Parameter("offset_bias", shape=(self._off_ch,), dtype=dtype,
                      init=offset_bias_initializer)
            if offset_use_bias else None)
        self.weight = Parameter(
            "weight", shape=(channels, in_channels // groups, kh, kw),
            dtype=dtype, init=weight_initializer, allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(channels,), dtype=dtype,
                               init=bias_initializer) if use_bias else None)

    def _finalize(self, x):
        in_ch = x.shape[1]
        kh, kw = self._kernel
        if not self.offset_weight.shape_known:
            self.offset_weight.shape = (self._off_ch, in_ch, kh, kw)
            self.offset_weight.finalize()
        if not self.weight.shape_known:
            self.weight.shape = (self._channels, in_ch // self._groups, kh,
                                 kw)
            self.weight.finalize()

    def forward(self, x):
        self._finalize(x)
        off_bias = (self.offset_bias.data()
                    if self.offset_bias is not None else None)
        conv = dict(kernel=self._kernel, stride=self._strides,
                    dilate=self._dilation, pad=self._padding)
        raw = npx.convolution(x, self.offset_weight.data(), off_bias,
                              num_filter=self._off_ch,
                              no_bias=off_bias is None, **conv)
        k = self._kernel[0] * self._kernel[1] * self._ndg
        bias = self.bias.data() if self.bias is not None else None
        deform = dict(num_filter=self._channels, num_group=self._groups,
                      num_deformable_group=self._ndg, no_bias=bias is None,
                      **conv)
        if self._modulated:
            out = npx.modulated_deformable_convolution(
                x, raw[:, :2 * k], npx.sigmoid(raw[:, 2 * k:]),
                self.weight.data(), bias, **deform)
        else:
            out = npx.deformable_convolution(x, raw, self.weight.data(),
                                             bias, **deform)
        if self._act:
            out = npx.activation(out, act_type=self._act)
        return out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"strides={self._strides}")


class ModulatedDeformableConvolution(DeformableConvolution):
    """DCNv2 layer (reference conv_layers.py:224): the inner convolution
    also gives a per-sample modulation mask (through a sigmoid)."""

    _modulated = True
