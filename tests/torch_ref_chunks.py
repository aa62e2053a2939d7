"""The reference's results for many parity cases from one traced program
a chunk of cases.

The layer-tail tests hold each case of the port against the reference's
`jit.to_static`. Tracing and compiling a program, and the eager ops
around it, cost more than the case itself, so the cases run in fixed
chunks of sorted names: one reference Layer holds a chunk's layers, its
forward runs every case of the chunk and adds each case's weighted sum
of its float outputs to one loss, and one backward gives every case's
gradients (a case's inputs and parameters reach only its own term). A
test module caches a chunk per process (`functools.lru_cache`), so a
test worker computes only the chunks its cases fall in.

The weighted sum is the same rule on both sides (:func:`weighted_loss`):
each float output in order, times weights uniform in [0.5, 1.5) drawn
from RandomState(123), summed.
"""
import functools
import operator
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

import paddle_tpu as ref


class Case(NamedTuple):
    """build(nn) -> layer, made after seed(0), or None for a function;
    call(layer or None, *tensors) -> the output nest; arrays, the numpy
    inputs; grad, the indices of the differentiated inputs."""
    build: Optional[Callable]
    call: Callable
    arrays: list
    grad: list


class Result(NamedTuple):
    """A case's reference results, as numpy: its output leaves; the
    gradient of each differentiated input (None where none reached it);
    its layer's state_dict as built and the gradient of each of its
    parameters by name (None where none reached it); and whether its
    outputs carried gradients (a float output under differentiated
    inputs or trainable parameters)."""
    outs: list
    input_grads: list
    state: dict
    param_grads: dict
    has_grad: bool


def leaves(out, cls):
    if isinstance(out, cls):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in leaves(o, cls)]
    return []


def weighted_loss(pd, outs, is_float):
    """Each float output times weights uniform in [0.5, 1.5) from
    RandomState(123), in order, summed; None without a float output.
    (No `continue` or branch on a tensor: the reference's dy2static
    rewrites the functions its traced forward calls.)"""
    rs = np.random.RandomState(123)
    terms = [(t * pd.to_tensor(rs.uniform(0.5, 1.5, list(t.shape)).astype(
        np.float32))).sum() for t in outs if is_float(t)]
    return functools.reduce(operator.add, terms) if terms else None


def _ref_float(t):
    return jnp.issubdtype(t._data.dtype, jnp.floating)


def run(cases):
    """{name: Case} -> {name: Result}, through one `ref.jit.to_static`
    program forward and one backward."""
    names = list(cases)
    layers = {}
    for n in names:
        if cases[n].build is not None:
            ref.seed(0)
            layers[n] = cases[n].build(ref.nn)
    states = {n: {k: np.asarray(v.numpy())
                  for k, v in layers[n].state_dict().items()}
              for n in layers}
    starts = list(np.cumsum([0] + [len(cases[n].arrays) for n in names]))

    class Chunk(ref.nn.Layer):
        def __init__(self):
            super().__init__()
            self.held = ref.nn.LayerList(list(layers.values()))

        def forward(self, *flat):
            outs = [leaves(cases[n].call(layers.get(n),
                                         *flat[lo:lo + len(cases[n].arrays)]),
                           ref.Tensor) for n, lo in zip(names, starts)]
            terms = [weighted_loss(ref, o, _ref_float) for o in outs]
            return outs, functools.reduce(
                operator.add, [t for t in terms if t is not None])

    ts = []
    for n in names:
        for j, a in enumerate(cases[n].arrays):
            t = ref.to_tensor(a)
            if j in cases[n].grad:
                t.stop_gradient = False
            ts.append(t)
    outs, total = ref.jit.to_static(Chunk())(*ts)
    total.backward()
    results, i = {}, 0
    for n, o in zip(names, outs):
        c = cases[n]
        its = ts[i:i + len(c.arrays)]
        i += len(c.arrays)
        params = (dict(layers[n].named_parameters()) if n in layers
                  else {})
        differentiated = bool(c.grad) or any(
            not p.stop_gradient for p in params.values())
        results[n] = Result(
            outs=[np.asarray(t.numpy()) for t in o],
            input_grads=[None if its[j].grad is None
                         else np.asarray(its[j].grad.numpy())
                         for j in c.grad],
            state=states.get(n, {}),
            param_grads={k: None if p.grad is None
                         else np.asarray(p.grad.numpy())
                         for k, p in params.items()},
            has_grad=differentiated and any(_ref_float(t) for t in o))
    return results


def chunks(names, size):
    """Fixed chunks of the sorted names: name -> its chunk (a tuple)."""
    names = sorted(names)
    out = {}
    for i in range(0, len(names), size):
        for n in names[i:i + size]:
            out[n] = tuple(names[i:i + size])
    return out
