"""ResNet V1 and V2 of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``; He et al. 1512.03385 and
1603.05027), built from the port's Gluon layers with the reference's
structure and parameter names, so ``collect_params()`` and ``.params``
files match the JAX package's. ``pretrained=True`` loads the model
store's weights (``resnet18_v1`` only; other depths raise).
"""
from __future__ import annotations

from ....base import MXNetError
from .... import numpy_extension as npx
from ... import nn
from ...block import HybridBlock

__all__ = [
    "ResNetV1", "ResNetV2",
    "BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
    "resnet101_v2", "resnet152_v2", "get_resnet",
]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions and the shortcut, ReLU after the sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return npx.activation(self.body(x) + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1, 3x3 and 1x1 convolutions (the stride on the first) and the
    shortcut, ReLU after the sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return npx.activation(self.body(x) + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block: BatchNorm and ReLU before each 3x3
    convolution; the shortcut takes the first activation."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = npx.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = npx.activation(self.bn2(x), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck (the stride on the 3x3 convolution)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = npx.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = npx.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = npx.activation(self.bn3(x), act_type="relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, in_channels):
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels))
    return layer


def _stem(features, channels, thumbnail):
    """A 3x3 convolution (``thumbnail``, for 32x32 images), else the 7x7
    stride-2 convolution, BatchNorm, ReLU and a 3x3 stride-2 max pool."""
    if thumbnail:
        features.add(_conv3x3(channels, 1, 0))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False))
        features.add(nn.BatchNorm())
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    """ResNet V1 (reference resnet.py ResNetV1): ``features`` (the stem,
    four stages, global average pooling) and the ``output`` Dense."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need "
                             f"{len(layers) + 1} channel counts")
        self.features = nn.HybridSequential()
        _stem(self.features, channels[0], thumbnail)
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, channels[i]))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet V2 (pre-activation; reference resnet.py ResNetV2): a
    BatchNorm without scale and shift on the input, the stem, four
    stages, BatchNorm, ReLU, global average pooling, ``Flatten`` and the
    ``output`` Dense."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need "
                             f"{len(layers) + 1} channel counts")
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False))
        _stem(self.features, channels[0], thumbnail)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, in_channels))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               device=None, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101 or
    152) layers (reference resnet.py get_resnet); ``kwargs`` go to the
    net (``classes``, ``thumbnail``). Its parameters are made by
    ``initialize()`` or ``load_parameters``; ``pretrained=True`` loads
    the model store's onto ``device`` (default ``gpu(0)``)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise MXNetError(f"Invalid resnet version: {version}. Options are "
                         "1 and 2.")
    block_type, layers, channels = resnet_spec[num_layers]
    net_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = net_class(block_class, layers, channels, **kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        _load_pretrained(net, f"resnet{num_layers}_v{version}", root,
                         device if device is not None else ctx)
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
