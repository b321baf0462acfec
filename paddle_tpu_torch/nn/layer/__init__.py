from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .extras import *  # noqa: F401,F403
from .extras import __all__ as _extras
from .layers import Layer, Parameter, ParamAttr
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Layer", "Parameter", "ParamAttr", *_activation, *_common,
           *_container, *_conv, *_norm, *_pooling, *_loss, *_rnn, *_extras,
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
