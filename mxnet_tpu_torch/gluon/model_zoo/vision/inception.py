"""Inception V3 of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; Szegedy et al.
1512.00567), with the reference's structure and parameter names: the
branches of each module run on the same input and are concatenated on
the channel axis. The final 8x8 average pool fixes the input at 299x299.
"""
from __future__ import annotations

from .... import numpy as _np
from ... import nn
from ...block import HybridBlock

__all__ = ["Inception3", "inception_v3"]

_SETTING_NAMES = ("channels", "kernel_size", "strides", "padding")


def _make_basic_conv(**kwargs):
    """Convolution without bias, BatchNorm (epsilon 0.001), ReLU."""
    out = nn.HybridSequential()
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    """An optional 3x3 pool ("avg": stride 1, padded; "max": stride 2),
    then a basic convolution per setting (channels, kernel_size,
    strides, padding; None keeps the default)."""
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        out.add(_make_basic_conv(**{
            name: value for name, value in zip(_SETTING_NAMES, setting)
            if value is not None}))
    return out


def _make_A(pool_features):
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B():
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7):
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D():
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    """The last modules: the 3x3 branches split into 1x3 and 3x1
    halves, concatenated."""

    def __init__(self):
        super().__init__()
        self.branch1 = _make_branch(None, (320, 1, None, None))
        self.branch2_stem = _make_branch(None, (384, 1, None, None))
        self.branch2_a = _make_branch(None, (384, (1, 3), None, (0, 1)))
        self.branch2_b = _make_branch(None, (384, (3, 1), None, (1, 0)))
        self.branch3_stem = _make_branch(None, (448, 1, None, None),
                                         (384, 3, None, 1))
        self.branch3_a = _make_branch(None, (384, (1, 3), None, (0, 1)))
        self.branch3_b = _make_branch(None, (384, (3, 1), None, (1, 0)))
        self.branch4 = _make_branch("avg", (192, 1, None, None))

    def forward(self, x):
        b1 = self.branch1(x)
        b2 = self.branch2_stem(x)
        b2 = _np.concatenate([self.branch2_a(b2), self.branch2_b(b2)],
                             axis=1)
        b3 = self.branch3_stem(x)
        b3 = _np.concatenate([self.branch3_a(b3), self.branch3_b(b3)],
                             axis=1)
        b4 = self.branch4(x)
        return _np.concatenate([b1, b2, b3, b4], axis=1)


class Inception3(HybridBlock):
    """Inception v3 (reference inception.py:133): the stem, modules A
    (x3), B, C (x4), D and E (x2), an 8x8 average pool, dropout and the
    ``output`` Dense."""

    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_InceptionE())
        self.features.add(_InceptionE())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, device=None,
                 **kwargs):
    """Inception v3; ``pretrained=True`` asks the model store, which has
    no weights for it and raises."""
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        _load_pretrained(net, "inceptionv3", root,
                         device if device is not None else ctx)
    return net
