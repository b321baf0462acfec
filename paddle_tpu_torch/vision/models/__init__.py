from .resnet import *  # noqa: F401,F403
from .resnet import __all__  # noqa: F401
