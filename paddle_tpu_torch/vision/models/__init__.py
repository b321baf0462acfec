from .lenet import LeNet
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = ["LeNet", *_resnet_all]
