"""VGG of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``; Simonyan & Zisserman
1409.1556): vgg11, 13, 16 and 19 and their BatchNorm variants, with the
reference's structure, parameter names and initializers (``normal`` for
the three Dense layers). The first Dense layer's ``in_units`` is
completed at the first forward (25088 at 224x224)."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = [
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg",
]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    """Stages of 3x3 convolutions (with BatchNorm when ``batch_norm``),
    each closed by a 2x2 max pool, two 4096-wide Dense layers with
    dropout, and the ``output`` Dense (reference vgg.py:39)."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False):
        super().__init__()
        if len(layers) != len(filters):
            raise MXNetError(f"{len(layers)} stages but {len(filters)} "
                             "filter counts")
        self.features = self._make_features(layers, filters, batch_norm)
        self.features.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
        self.features.add(nn.Dropout(rate=0.5))
        self.features.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
        self.features.add(nn.Dropout(rate=0.5))
        self.output = nn.Dense(classes, weight_initializer="normal")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, device=None,
            **kwargs):
    """VGG of ``num_layers`` (11, 13, 16 or 19) layers; ``batch_norm=True``
    for the ``_bn`` variants. ``pretrained=True`` asks the model store,
    which has no weights for them and raises."""
    if num_layers not in vgg_spec:
        raise MXNetError(f"Invalid VGG depth {num_layers}; options "
                         f"{sorted(vgg_spec)}")
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        suffix = "_bn" if kwargs.get("batch_norm") else ""
        _load_pretrained(net, f"vgg{num_layers}{suffix}", root,
                         device if device is not None else ctx)
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
