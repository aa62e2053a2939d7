"""Functional autograd: jacobian / hessian / jvp / vjp, over torch's
autograd. Port of `paddle_tpu/autograd/functional.py`.

  * ``paddle.autograd.jacobian`` / ``hessian``: lazy Jacobian objects
    with a row cache (paddle's `python/paddle/autograd/autograd.py:461`
    Jacobian class, `:563` jacobian(), `:652` hessian()).
  * ``vjp`` / ``jvp``: the functional forms
    (`python/paddle/incubate/autograd/functional.py:50,124`).

Rows are pulled through `autograd.grad` (torch.autograd.grad) with
``create_graph=True``, so a Hessian differentiates through them, and
jvp is two vjp passes (the double-backward trick), as in the reference
and in paddle's dygraph mode. Evaluation stays lazy along the output
axis with a row cache: ``J[:, i]`` computes only row ``i``.
"""
from __future__ import annotations

from typing import Sequence

import math


def _as_seq(xs):
    from ..core.tensor import Tensor

    if isinstance(xs, Tensor):
        return (xs,), False
    return tuple(xs), True


def _grad_rows(ys_row, xs):
    """One backward pass: d(ys_row)/d(xs), graph kept + recorded so a second
    ``grad`` (Hessian) can flow through the result. Unreached inputs yield
    zeros (reference `_grad_for_jacobian` allow_unused contract)."""
    from . import engine
    import paddle_tpu_torch as paddle

    seq, _ = _as_seq(xs)
    # explicit ones cotangent: paddle.grad fills ones for any-shape outputs,
    # this engine auto-seeds scalars only
    seed = paddle.ones_like(ys_row)
    gs = engine.grad(ys_row, list(seq), grad_outputs=[seed],
                     create_graph=True, retain_graph=True, allow_unused=True)
    out = []
    for g, x in zip(gs, seq):
        if g is None:
            import paddle_tpu_torch as paddle

            g = paddle.zeros_like(x)
        out.append(g)
    return out


class Jacobian:
    """Lazily evaluated Jacobian of ``ys`` w.r.t. ``xs``.

    ``batch_axis=None``: ys/xs are 0-D or 1-D; the matrix shape is
    ``[M, N]`` (0-D axes squeezed away). ``batch_axis=0``: ys/xs are
    ``[B, M]`` / ``[B, N]`` (1-D means a squeezed singleton), matrix shape
    ``[B, M, N]``. Indexing evaluates only the output rows the index
    touches; evaluated rows are cached. Reference:
    `python/paddle/autograd/autograd.py:35-105` (class contract),
    `:300-340` (lazy row indexing).
    """

    def __init__(self, ys, xs, is_batched: bool = False):
        self._ys = ys
        self._xs = xs
        self._batched = bool(is_batched)
        lo, hi = (1, 2) if self._batched else (0, 1)
        for name, t in (("ys", ys), ("xs", xs)):
            if not lo <= len(t.shape) <= hi:
                raise ValueError(
                    f"{name}.ndim should be in [{lo}, {hi}] when "
                    f"is_batched={self._batched}, but got {len(t.shape)}")
        # public shape follows the ORIGINAL ndims (0-D / squeezed axes
        # disappear); the internal matrix always carries [B?, M, N]
        self._ys_vec = len(ys.shape) > (1 if self._batched else 0)
        self._xs_vec = len(xs.shape) > (1 if self._batched else 0)
        self._m = ys.shape[-1] if self._ys_vec else 1
        self._n = xs.shape[-1] if self._xs_vec else 1
        self.shape = (([ys.shape[0]] if self._batched else [])
                      + ([self._m] if self._ys_vec else [])
                      + ([self._n] if self._xs_vec else []))
        self._cache: dict = {}

    # -- evaluation ------------------------------------------------------

    def _row(self, i: int):
        """d ys[..., i] / d xs as a Tensor of shape [B?, N]."""
        if i not in self._cache:
            import paddle_tpu_torch as paddle

            if self._batched:
                y = self._ys[:, i] if self._ys_vec else self._ys
            else:
                y = self._ys[i] if self._ys_vec else self._ys
            (g,) = _grad_rows(y, self._xs)
            want = ([g.shape[0], self._n] if self._batched else [self._n])
            self._cache[i] = g.reshape(want)
        return self._cache[i]

    def _matrix(self, rows=None):
        """Assemble [B?, len(rows), N] from cached/evaluated rows."""
        import paddle_tpu_torch as paddle

        rows = range(self._m) if rows is None else rows
        axis = 1 if self._batched else 0
        parts = [paddle.unsqueeze(self._row(i), axis) for i in rows]
        return parts[0] if len(parts) == 1 else paddle.concat(parts, axis)

    def _evaluate_all(self):
        full = self._matrix()
        # squeeze the axes the public shape omits (0-D ys/xs)
        if not self._ys_vec:
            full = full.squeeze(1 if self._batched else 0)
        if not self._xs_vec:
            full = full.squeeze(-1)
        return full

    # -- indexing --------------------------------------------------------

    def __getitem__(self, indexes):
        if len(self.shape) == 0:
            raise IndexError("0-D tensor can not be indexed.")
        if not isinstance(indexes, tuple):
            indexes = (indexes,)
        if any(idx is Ellipsis for idx in indexes):
            raise IndexError("Ellipsis index currently is not supported.")
        # lift the public index onto the internal [B?, M, N] matrix:
        # missing ys/xs axes are pinned to their only element
        it = iter(indexes)
        full = []
        batch_idx = next(it, slice(None)) if self._batched else None
        row_idx = next(it, slice(None)) if self._ys_vec else 0
        col_idx = next(it, slice(None)) if self._xs_vec else 0
        if len(indexes) > (int(self._batched) + int(self._ys_vec)
                           + int(self._xs_vec)):
            raise IndexError(
                f"too many indices for Jacobian of shape {self.shape}")
        rows = self._lazy_rows(row_idx)
        mat = self._matrix(rows)  # [B?, len(rows), N]
        # row_idx has been materialized into mat's row axis
        local_row = (slice(None) if isinstance(row_idx, slice)
                     else 0)
        full = ([batch_idx] if self._batched else []) + [local_row, col_idx]
        out = mat[tuple(full)]
        return out

    def _lazy_rows(self, row_idx):
        if isinstance(row_idx, slice):
            return list(range(*row_idx.indices(self._m)))
        i = int(row_idx)
        if i < 0:
            i += self._m
        if not 0 <= i < self._m:
            raise IndexError(f"row index {row_idx} out of range [0,{self._m})")
        return [i]

    # -- tensor-like delegation (hessian builds on this; reference
    #    autograd.py:108 __getattr__ delegates to the evaluated matrix) ---

    def __getattr__(self, name):
        if name.startswith("_") or name == "shape":
            raise AttributeError(name)
        return getattr(self._evaluate_all(), name)

    def _binop(self, other, op):
        lhs = self._evaluate_all()
        rhs = other._evaluate_all() if isinstance(other, Jacobian) else other
        return getattr(lhs, op)(rhs)

    def __add__(self, o):
        return self._binop(o, "__add__")

    def __sub__(self, o):
        return self._binop(o, "__sub__")

    def __mul__(self, o):
        return self._binop(o, "__mul__")

    def __truediv__(self, o):
        return self._binop(o, "__truediv__")

    def __matmul__(self, o):
        return self._binop(o, "__matmul__")

    def __eq__(self, o):  # noqa: PLW1641 ; tensor-semantics equality
        return self._binop(o, "__eq__")

    def __ne__(self, o):
        return self._binop(o, "__ne__")


class Hessian(Jacobian):
    pass


def jacobian(ys, xs, batch_axis=None):
    """Jacobian(s) of ``ys`` w.r.t. ``xs`` (reference autograd.py:563).

    Sequence inputs fan out into tuples of ``Jacobian`` objects with the
    same nesting as the reference: (ys seq, xs seq) -> tuple of tuples.
    """
    if batch_axis is not None and batch_axis != 0:
        raise ValueError(
            f"batch_axis should be None or 0, but got {batch_axis}.")
    batched = batch_axis is not None
    ys_seq = isinstance(ys, Sequence)
    xs_seq = isinstance(xs, Sequence)
    if ys_seq and xs_seq:
        return tuple(tuple(Jacobian(y, x, batched) for x in xs) for y in ys)
    if ys_seq:
        return tuple(Jacobian(y, xs, batched) for y in ys)
    if xs_seq:
        return tuple(Jacobian(ys, x, batched) for x in xs)
    return Jacobian(ys, xs, batched)


def hessian(ys, xs, batch_axis=None):
    """Hessian(s) of scalar ``ys`` w.r.t. ``xs`` (reference autograd.py:652).

    ``batch_axis=None`` needs ys.numel()==1; ``batch_axis=0`` needs per-batch
    scalars ``[B]`` (or ``[B, 1]``). Implemented as jacobian-of-jacobian:
    the inner rows are produced with ``create_graph=True`` so the outer pass
    differentiates through them.
    """
    from ..core.tensor import Tensor

    if batch_axis is None:
        if int(ys.numel()) > 1:
            raise ValueError(
                f"Only support ys.numel()({int(ys.numel())})==1 "
                "when batch_axis is None.")
        ys = ys.reshape([])
    elif batch_axis == 0:
        if len(ys.shape) > 1 and math.prod(ys.shape[1:]) > 1:
            raise ValueError("Only support per-batch scalar ys "
                             "when batch_axis=0.")
        ys = ys.reshape([-1])
    else:
        raise ValueError(
            f"batch_axis should be None or 0, but got {batch_axis}.")

    inner = jacobian(ys, xs, batch_axis)
    if isinstance(xs, Sequence):
        rows = tuple(_grad_first(j) for j in inner)
        result = tuple(
            tuple(Hessian(r, x, batch_axis is not None) for x in xs)
            for r in rows)
        return result
    h = Hessian.__new__(Hessian)
    g = _grad_first(inner)
    Hessian.__init__(h, g, xs, batch_axis is not None)
    return h


def _grad_first(jac: Jacobian):
    """The first-order gradient vector dys/dxs as a graph-carrying Tensor
    (ys is scalar per hessian's contract, so the Jacobian has one row)."""
    return jac._evaluate_all()


# ---------------------------------------------------------------------------
# functional jvp / vjp (incubate.autograd)
# ---------------------------------------------------------------------------

def _detached_inputs(xs):
    """Fresh differentiable copies so func's graph hangs off OUR roots
    (reference functional.py `_separate`)."""
    seq, was_seq = _as_seq(xs)
    outs = []
    for x in seq:
        d = x.detach()
        d.stop_gradient = False
        outs.append(d)
    return outs, was_seq


def _ones_like_each(ts):
    import paddle_tpu_torch as paddle

    return [paddle.ones_like(t) for t in ts]


def _pack(items, was_seq):
    return tuple(items) if was_seq else items[0]


def vjp(func, xs, v=None):
    """(func(xs), v @ J) ; reverse mode (reference functional.py:50)."""
    from . import engine

    ins, was_seq = _detached_inputs(xs)
    ys = func(*ins) if was_seq else func(ins[0])
    ys_list, _ = _as_seq(ys)
    if v is None:
        v_list = _ones_like_each(ys_list)
    else:
        v_list, _ = _as_seq(v)
        for vi, yi in zip(v_list, ys_list):
            if list(vi.shape) != list(yi.shape):
                raise RuntimeError(
                    f"v shape {vi.shape} does not match output "
                    f"shape {yi.shape}")
    gs = engine.grad(list(ys_list), ins, grad_outputs=list(v_list),
                     create_graph=True, retain_graph=True, allow_unused=True)
    return ys, _pack(gs, was_seq)


def jvp(func, xs, v=None):
    """(func(xs), J @ v) ; forward mode via the double-backward trick
    (reference functional.py:124 + `_double_backward_trick`): a vjp with a
    symbolic cotangent, then a vjp of that result w.r.t. the cotangent."""
    from . import engine
    import paddle_tpu_torch as paddle

    ins, was_seq = _detached_inputs(xs)
    ys = func(*ins) if was_seq else func(ins[0])
    ys_list, ys_seq = _as_seq(ys)
    if v is None:
        v_list = _ones_like_each(ins)
    else:
        v_list, _ = _as_seq(v)
        for vi, xi in zip(v_list, ins):
            if list(vi.shape) != list(xi.shape):
                raise RuntimeError(
                    f"v shape {vi.shape} does not match input "
                    f"shape {xi.shape}")
    # cotangent placeholders: value irrelevant, graph participation required
    cots = []
    for y in ys_list:
        c = paddle.zeros_like(y)
        c.stop_gradient = False
        cots.append(c)
    xs_bar = engine.grad(list(ys_list), ins, grad_outputs=cots,
                         create_graph=True, retain_graph=True,
                         allow_unused=True)
    xs_bar = [g if g is not None else paddle.zeros_like(x)
              for g, x in zip(xs_bar, ins)]
    out = engine.grad(xs_bar, cots, grad_outputs=list(v_list),
                      create_graph=True, retain_graph=True, allow_unused=True)
    out = [g if g is not None else paddle.zeros_like(y)
           for g, y in zip(out, ys_list)]
    return ys, _pack(out, ys_seq)
