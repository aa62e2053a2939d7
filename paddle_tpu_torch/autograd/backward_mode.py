"""paddle.autograd.backward parity (port of
`paddle_tpu/autograd/backward_mode.py`)."""
from __future__ import annotations

from ..core.tensor import Tensor
from . import engine


def backward(tensors, grad_tensors=None, retain_graph=False):
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is not None and isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    engine.run_backward(tensors, grad_tensors, retain_graph=retain_graph)
