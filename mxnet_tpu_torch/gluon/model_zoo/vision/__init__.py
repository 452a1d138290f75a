"""Vision model zoo of the port: LeNet-5, the ResNet v1 family and
Inception v3."""
from ....base import MXNetError
from .inception import Inception3, inception_v3  # noqa: F401
from .lenet import LeNet, lenet  # noqa: F401
from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1)

_models = {"resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
           "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
           "resnet152_v1": resnet152_v1, "lenet": lenet,
           "inceptionv3": inception_v3}


def get_model(name, **kwargs):
    """A vision model by its zoo name (LeNet-5, the ResNet v1 family,
    ``inceptionv3``)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"Model '{name}' is not ported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
