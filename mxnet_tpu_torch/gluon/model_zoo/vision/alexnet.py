"""AlexNet of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``; Krizhevsky et al. 2012),
with the reference's structure and parameter names."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """Five convolutions, three max pools, two 4096-wide Dense layers
    with dropout, and the ``output`` Dense (reference alexnet.py:36)."""

    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                    padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, device=None, **kwargs):
    """AlexNet; ``pretrained=True`` asks the model store, which has no
    weights for it and raises."""
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import _load_pretrained

        _load_pretrained(net, "alexnet", root,
                         device if device is not None else ctx)
    return net
