"""Vision model zoo of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): every net the
reference registers, under its names: AlexNet, DenseNet, Inception V3,
MobileNet V1 and V2, ResNet V1 and V2, SqueezeNet and VGG.
``pretrained=True`` loads the model store's weights
(:mod:`~mxnet_tpu_torch.gluon.model_zoo.model_store`) for the models it
holds and raises for the others."""
from ....base import MXNetError
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .alexnet import __all__ as _alexnet_all
from .densenet import __all__ as _densenet_all
from .inception import __all__ as _inception_all
from .mobilenet import __all__ as _mobilenet_all
from .resnet import __all__ as _resnet_all
from .squeezenet import __all__ as _squeezenet_all
from .vgg import __all__ as _vgg_all

__all__ = (["get_model"] + _alexnet_all + _densenet_all + _inception_all
           + _mobilenet_all + _resnet_all + _squeezenet_all + _vgg_all)

# `from .alexnet import *` binds the function alexnet over the submodule
# name in this namespace, so the registry takes the module-level names
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
    "vgg11": vgg11,  # noqa: F405
    "vgg13": vgg13,  # noqa: F405
    "vgg16": vgg16,  # noqa: F405
    "vgg19": vgg19,  # noqa: F405
    "vgg11_bn": vgg11_bn,  # noqa: F405
    "vgg13_bn": vgg13_bn,  # noqa: F405
    "vgg16_bn": vgg16_bn,  # noqa: F405
    "vgg19_bn": vgg19_bn,  # noqa: F405
    "alexnet": alexnet,  # noqa: F405
    "densenet121": densenet121,  # noqa: F405
    "densenet161": densenet161,  # noqa: F405
    "densenet169": densenet169,  # noqa: F405
    "densenet201": densenet201,  # noqa: F405
    "squeezenet1.0": squeezenet1_0,  # noqa: F405
    "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
    "mobilenet1.0": mobilenet1_0,  # noqa: F405
    "mobilenet0.75": mobilenet0_75,  # noqa: F405
    "mobilenet0.5": mobilenet0_5,  # noqa: F405
    "mobilenet0.25": mobilenet0_25,  # noqa: F405
    "mobilenetv2_1.0": mobilenet_v2_1_0,  # noqa: F405
    "mobilenetv2_0.75": mobilenet_v2_0_75,  # noqa: F405
    "mobilenetv2_0.5": mobilenet_v2_0_5,  # noqa: F405
    "mobilenetv2_0.25": mobilenet_v2_0_25,  # noqa: F405
}


def get_model(name, **kwargs):
    """A model by name (reference vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)
