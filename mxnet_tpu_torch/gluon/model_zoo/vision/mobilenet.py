"""MobileNet V1 and V2 of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``; Howard et al.
1704.04861, Sandler et al. 1801.04381), with the reference's structure
and parameter names. The depthwise convolutions (``groups`` equal to the
channels) run in cuDNN on the card. ``pretrained=True`` loads the model
store's weights (``mobilenetv2_1.0`` only; other names raise).
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = [
    "MobileNet", "MobileNetV2",
    "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
    "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
    "mobilenet_v2_0_25", "get_mobilenet", "get_mobilenet_v2",
]


class ReLU6(HybridBlock):
    """min(max(x, 0), 6)."""

    def forward(self, x):
        return x.clip(0, 6)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0,
              num_group=1, active=True, relu6=False):
    """Convolution without bias, BatchNorm, and ReLU or ReLU6."""
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    if active:
        out.add(ReLU6() if relu6 else nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    """A depthwise 3x3 and a pointwise 1x1 convolution."""
    _add_conv(out, channels=dw_channels, kernel=3, stride=stride,
              pad=1, num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels=channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """MobileNetV2's inverted residual: expand by ``t`` (1x1), depthwise
    3x3, project (1x1, no activation); the shortcut where the stride is
    1 and the widths agree."""

    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                  pad=1, num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    """MobileNet V1 (reference mobilenet.py:85): a stride-2 3x3
    convolution, 13 depthwise-separable pairs, global average pooling
    and the ``output`` Dense; widths scaled by ``multiplier``."""

    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, channels=int(32 * multiplier), kernel=3,
                  pad=1, stride=2)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                       + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2] * 3 + [1] * 5 + [2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                         stride=s)
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet V2 (reference mobilenet.py:130): a stride-2 3x3
    convolution, 17 linear bottlenecks, a 1x1 convolution to 1280
    channels, global average pooling, and a 1x1 convolution to
    ``classes`` as the ``output``."""

    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3,
                  stride=2, pad=1, relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                             + [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                          + [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_channels=in_c, channels=c,
                                               t=t, stride=s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, use_bias=False))
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  device=None, **kwargs):
    """MobileNet V1 at width ``multiplier`` (1.0, 0.75, 0.5, 0.25);
    ``pretrained=True`` loads the model store's weights onto ``device``
    (default ``gpu(0)``)."""
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        _load_pretrained(net, f"mobilenet{multiplier}", root,
                         device if device is not None else ctx)
    return net


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     device=None, **kwargs):
    """MobileNet V2 at width ``multiplier``; ``pretrained=True`` loads
    the model store's weights onto ``device`` (default ``gpu(0)``)."""
    net = MobileNetV2(multiplier, **kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        _load_pretrained(net, f"mobilenetv2_{multiplier}", root,
                         device if device is not None else ctx)
    return net


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
