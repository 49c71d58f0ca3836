"""SqueezeNet 1.0 and 1.1 of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``; Iandola et al.
1602.07360), with the reference's structure and parameter names. Its
max pools round their output size up (``ceil_mode=True``)."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    """A 1x1 squeeze, then 1x1 and 3x3 expands concatenated."""
    out = nn.HybridSequential()
    out.add(_make_fire_conv(squeeze_channels, 1))
    expand = nn.HybridConcatenate(axis=1)
    expand.add(_make_fire_conv(expand1x1_channels, 1))
    expand.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(expand)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


def _ceil_pool():
    return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)


class SqueezeNet(HybridBlock):
    """SqueezeNet ``version`` "1.0" or "1.1" (reference squeezenet.py:54):
    ``features`` and a 1x1-convolution ``output`` head."""

    def __init__(self, version, classes=1000):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise MXNetError(
                f"Unsupported SqueezeNet version {version}: 1.0 or 1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(_ceil_pool())
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_ceil_pool())
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_ceil_pool())
            self.features.add(_make_fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(_ceil_pool())
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_ceil_pool())
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_ceil_pool())
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_make_fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1))
        self.output.add(nn.Activation("relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   device=None, **kwargs):
    """SqueezeNet ``version``; ``pretrained=True`` asks the model store,
    which has no weights for it and raises."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        _load_pretrained(net, f"squeezenet{version}", root,
                         device if device is not None else ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
