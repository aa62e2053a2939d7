"""Reverse mode over torch's autograd: `run_backward` and `grad`.

Port of `paddle_tpu/autograd/engine.py`. The reference keeps a tape of
GradNodes holding `jax.vjp` pullbacks, because jax has none; the port's
ops record into torch's graph as they run (`ops/dispatch.py`), so this
module maps paddle's entry points onto `torch.autograd.backward` and
`torch.autograd.grad`, keeping paddle's rules:

- an implicit seed gradient only for a float tensor of one element;
- a second backward through a freed graph raises (torch's own error);
- `grad` writes no tensor's `.grad` and returns None for an unused
  input only with ``allow_unused=True``; ``retain_graph`` defaults to
  ``create_graph``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.tensor import Tensor, _unwrap


def _seed(t: Tensor, g):
    garr = _unwrap(g)
    if garr is not None:
        return garr
    d = t._data
    if not (d.is_floating_point() or d.is_complex()):
        raise RuntimeError(
            "grad can be implicitly created only for floating-point scalar "
            f"outputs; got dtype {d.dtype}")
    if d.numel() != 1:
        raise RuntimeError(
            "grad can be implicitly created only for scalar outputs; "
            f"got shape {list(d.shape)}")
    return torch.ones_like(d)


def run_backward(tensors: Sequence[Tensor],
                 grad_tensors: Optional[Sequence] = None,
                 retain_graph: bool = False):
    """Accumulate d(tensors)/d(leaf) into every leaf's `.grad` that does
    not stop gradient (paddle.autograd.backward)."""
    grad_tensors = grad_tensors or [None] * len(tensors)
    if len(grad_tensors) != len(tensors):
        raise ValueError("grad_tensors length must match tensors length")
    outs, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        seed = _seed(t, g)
        if not t._data.requires_grad:
            continue     # a tensor outside any graph contributes nothing
        outs.append(t._data)
        seeds.append(seed)
    if outs:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad parity: the gradients of `outputs` with respect to
    `inputs`, as Tensors (with their own graph under create_graph)."""
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = bool(create_graph)
    seeds = [_seed(t, g) for t, g in zip(outputs, grad_outputs)]
    got = torch.autograd.grad(
        [t._data for t in outputs], [t._data for t in inputs], seeds,
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=True)
    results = []
    for slot, g in enumerate(got):
        if g is None and not allow_unused:
            raise RuntimeError(
                f"The {slot}-th input has no gradient path to outputs; "
                "set allow_unused=True to return None for it")
        results.append(None if g is None else Tensor._wrap(g))
    return results
