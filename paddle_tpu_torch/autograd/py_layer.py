"""PyLayer: a user-defined forward and backward — port of
`paddle_tpu/autograd/py_layer.py`, over `torch.autograd.Function`.

`apply` runs the user's `forward(ctx, *args)` on port Tensors with
autograd off and, when any Tensor argument takes a gradient, records
one torch Function node whose backward calls the user's
`backward(ctx, *grads)`. As in the reference, the gradients it returns
are matched in order to the Tensor arguments that take a gradient
(positional ones first, then keyword ones); the others get none.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "PyLayerMeta", "LegacyPyLayer"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


def _as_torch(g):
    if g is None:
        return None
    return g._data if isinstance(g, Tensor) else torch.as_tensor(g)


class PyLayerMeta(type):
    """The reference's PyLayer metaclass (no behaviour of its own)."""


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        keys = list(kwargs)
        slots = ([("a", i) for i, a in enumerate(args)
                  if isinstance(a, Tensor) and not a.stop_gradient]
                 + [("k", k) for k in keys
                    if isinstance(kwargs[k], Tensor)
                    and not kwargs[k].stop_gradient])
        if not slots or not torch.is_grad_enabled():
            with torch.no_grad():
                return cls.forward(ctx, *args, **kwargs)
        box = {}

        class _Node(torch.autograd.Function):
            @staticmethod
            def forward(fctx, *datas):
                a, kw = list(args), dict(kwargs)
                for (kind, key), d in zip(slots, datas):
                    t = Tensor._wrap(d)
                    if kind == "a":
                        a[key] = t
                    else:
                        kw[key] = t
                out = cls.forward(ctx, *a, **kw)
                box["single"] = isinstance(out, Tensor)
                outs = [out] if box["single"] else list(out)
                datas_out = tuple(o._data for o in outs)
                nondiff = [d for d in datas_out
                           if not (d.is_floating_point() or d.is_complex())]
                if nondiff:
                    fctx.mark_non_differentiable(*nondiff)
                return datas_out

            @staticmethod
            def backward(fctx, *grads):
                cots = tuple(Tensor._wrap(g) for g in grads)
                with torch.no_grad():
                    res = cls.backward(ctx, *cots)
                if res is None or isinstance(res, Tensor):
                    res = (res,)
                res = [_as_torch(g) for g in res]
                return tuple(res[i] if i < len(res) else None
                             for i in range(len(slots)))

        inputs = [args[key] if kind == "a" else kwargs[key]
                  for kind, key in slots]
        out = _Node.apply(*[t._data for t in inputs])
        wrapped = [Tensor._wrap(d) for d in out]
        return wrapped[0] if box["single"] else tuple(wrapped)


LegacyPyLayer = PyLayer
