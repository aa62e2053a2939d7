"""paddle.optimizer-compatible API (reference: python/paddle/optimizer):
port of `paddle_tpu/optimizer/__init__.py`."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    ASGD,
    LBFGS,
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    Lamb,
    Momentum,
    NAdam,
    Optimizer,
    RAdam,
    RMSProp,
    Rprop,
)
