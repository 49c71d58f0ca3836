"""Vision model zoo of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): the ten ResNets, under
the reference's names. AlexNet, DenseNet, Inception, MobileNet,
SqueezeNet and VGG are not ported yet."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = ["get_model"] + _resnet_all

_models = {
    "resnet18_v1": resnet18_v1,  # noqa: F405
    "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1,  # noqa: F405
    "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1,  # noqa: F405
    "resnet18_v2": resnet18_v2,  # noqa: F405
    "resnet34_v2": resnet34_v2,  # noqa: F405
    "resnet50_v2": resnet50_v2,  # noqa: F405
    "resnet101_v2": resnet101_v2,  # noqa: F405
    "resnet152_v2": resnet152_v2,  # noqa: F405
}


def get_model(name, **kwargs):
    """A model by name (reference vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"Model {name} is not supported. Available: {sorted(_models)} "
            "(the reference's other vision nets are not ported yet)")
    return _models[name](**kwargs)
