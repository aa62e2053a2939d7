"""paddle.nn-compatible layer library (reference:
python/paddle/nn/__init__.py): port of `paddle_tpu/nn/__init__.py`,
without the rnn and extra layer modules (a later slice)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .layer.activation import (  # noqa: F401
    CELU,
    ELU,
    GELU,
    GLU,
    SELU,
    Hardshrink,
    Hardsigmoid,
    Hardswish,
    Hardtanh,
    LeakyReLU,
    LogSigmoid,
    LogSoftmax,
    Maxout,
    Mish,
    PReLU,
    ReLU,
    ReLU6,
    Sigmoid,
    SiLU,
    Silu,
    Softmax,
    Softplus,
    Softshrink,
    Softsign,
    Swish,
    Tanh,
    Tanhshrink,
    ThresholdedReLU,
)
from .layer.common import (  # noqa: F401
    CosineSimilarity,
    Dropout,
    Dropout2D,
    Embedding,
    Flatten,
    Identity,
    Linear,
    Pad2D,
    Upsample,
    ZeroPad2D,
)
from .layer.container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .layer.conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D  # noqa: F401
from .layer.layers import Layer  # noqa: F401
from .layer.loss import (  # noqa: F401
    BCELoss,
    BCEWithLogitsLoss,
    CrossEntropyLoss,
    CTCLoss,
    KLDivLoss,
    L1Loss,
    MarginRankingLoss,
    MSELoss,
    NLLLoss,
    SmoothL1Loss,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool2D,
    AdaptiveMaxPool2D,
    AvgPool1D,
    AvgPool2D,
    MaxPool1D,
    MaxPool2D,
)
from .layer.norm import (  # noqa: F401
    BatchNorm,
    BatchNorm1D,
    BatchNorm2D,
    BatchNorm3D,
    GroupNorm,
    InstanceNorm1D,
    InstanceNorm2D,
    InstanceNorm3D,
    LayerNorm,
    LocalResponseNorm,
    RMSNorm,
    SyncBatchNorm,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from .param_attr import ParamAttr  # noqa: F401
