"""paddle.incubate of the port: the fused functional ops (`nn.functional`).

Counterpart of `paddle_tpu/incubate/__init__.py`; MoE, the incubate
optimizers, autograd and distributed parts wait for later slices."""
from . import nn

__all__ = ["nn"]
