"""The top-level names of paddle's `__all__` that are compositions or
aliases rather than ops: port of `paddle_tpu/tensor/compat_ext.py`.

numpy-style stacking and splitting, dtype and value predicates, the
in-place functional spellings (`paddle.cos_(x)`), distances and
histograms, functional scatter updates, dlpack, and small utilities.
The stacking and splitting names are built from the registered ops, as
in the reference; the rest run torch on the Tensors' data and wrap the
result, so torch's autograd records them (the reference's jnp helpers
are outside its tape). Random helpers draw from `core/rng.py`'s
generators: their values cannot match the reference's (torch Philox
against jax threefry), only their shapes, types and laws.
`paddle_tpu_torch/__init__.py` exposes `__all__` at the top level.
"""
from __future__ import annotations

import itertools
import math as _math

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core import rng as _rng
from ..core.tensor import Tensor, to_tensor
from ..ops.dispatch import OPS

__all__: list = []   # filled by _public()

inf = float("inf")
newaxis = None


def _public(fn, name=None):
    __all__.append(name or fn.__name__)
    return fn


def _u(x):
    """The torch tensor of a Tensor; anything else as a tensor."""
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _w(a):
    return Tensor._wrap(a)


def _seq(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


# ---------------------------------------------------------------------------
# numpy-style stacking / splitting (built on the registered ops)
# ---------------------------------------------------------------------------

@_public
def atleast_1d(*inputs):
    outs = [OPS["reshape"](x, [1]) if len(x.shape) == 0 else x
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


@_public
def atleast_2d(*inputs):
    outs = []
    for x in inputs:
        nd = len(x.shape)
        if nd == 0:
            outs.append(OPS["reshape"](x, [1, 1]))
        elif nd == 1:
            outs.append(OPS["unsqueeze"](x, 0))
        else:
            outs.append(x)
    return outs[0] if len(outs) == 1 else outs


@_public
def atleast_3d(*inputs):
    outs = []
    for x in inputs:
        nd = len(x.shape)
        if nd == 0:
            outs.append(OPS["reshape"](x, [1, 1, 1]))
        elif nd == 1:
            outs.append(OPS["reshape"](x, [1, list(x.shape)[0], 1]))
        elif nd == 2:
            outs.append(OPS["unsqueeze"](x, 2))
        else:
            outs.append(x)
    return outs[0] if len(outs) == 1 else outs


@_public
def hstack(x):
    xs = [atleast_1d(t) for t in _seq(x)]
    return OPS["concat"](xs, 0 if len(xs[0].shape) <= 1 else 1)


@_public
def vstack(x):
    return OPS["concat"]([atleast_2d(t) for t in _seq(x)], 0)


row_stack = _public(vstack, "row_stack")


@_public
def dstack(x):
    return OPS["concat"]([atleast_3d(t) for t in _seq(x)], 2)


@_public
def column_stack(x):
    return OPS["concat"]([OPS["unsqueeze"](t, 1) if len(t.shape) == 1 else t
                          for t in _seq(x)], 1)


@_public
def tensor_split(x, num_or_indices, axis=0):
    """numpy.array_split's rule: unequal trailing sections allowed."""
    n = list(x.shape)[axis]
    if isinstance(num_or_indices, int):
        k, m = divmod(n, num_or_indices)
        sizes = [k + 1] * m + [k] * (num_or_indices - m)
        bounds = np.cumsum([0] + sizes)
    else:
        bounds = [0] + [int(i) for i in num_or_indices] + [n]
    # the registry's `slice` waits for ROADMAP item 7: index instead
    lead = (slice(None),) * (axis % len(x.shape))
    return [x[lead + (slice(int(s), int(e)),)]
            for s, e in zip(bounds[:-1], bounds[1:])]


@_public
def hsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=0 if len(x.shape) == 1 else 1)


@_public
def vsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=0)


@_public
def dsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=2)


@_public
def unflatten(x, axis, shape):
    old = list(x.shape)
    axis = axis % len(old)
    return OPS["reshape"](x, old[:axis] + list(shape) + old[axis + 1:])


@_public
def view(x, shape_or_dtype):
    if isinstance(shape_or_dtype, (list, tuple)):
        return OPS["view_shape"](x, list(shape_or_dtype))
    return OPS["view_dtype"](x, shape_or_dtype)


@_public
def view_as(x, other):
    return OPS["view_shape"](x, list(other.shape))


@_public
def matrix_transpose(x):
    perm = list(range(len(x.shape)))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    return OPS["transpose"](x, perm)


@_public
def t(x):
    nd = len(x.shape)
    if nd > 2:
        raise ValueError("paddle.t expects a tensor with ndim <= 2")
    return x if nd < 2 else OPS["transpose"](x, [1, 0])


@_public
def rank(x):
    return to_tensor(len(x.shape), dtype="int32", place=x.place)


@_public
def tolist(x):
    return x.tolist() if isinstance(x, Tensor) else np.asarray(x).tolist()


@_public
def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@_public
def tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)) and len(axes) == 2 \
            and isinstance(axes[0], int):
        axes = ([axes[0]], [axes[1]])
    return _w(torch.tensordot(_u(x), _u(y), dims=axes))


@_public
def cartesian_prod(x):
    xs = [_u(a).reshape(-1) for a in _seq(x)]
    grids = torch.meshgrid(*xs, indexing="ij")
    return _w(torch.stack([g.reshape(-1) for g in grids], dim=-1))


@_public
def combinations(x, r=2, with_replacement=False):
    n = int(np.prod(x.shape)) if len(x.shape) else 1
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    a = _u(x)
    idx = torch.as_tensor(np.array(list(it), np.int64).reshape(-1, r),
                          device=a.device)
    return _w(a.reshape(-1)[idx])


@_public
def vander(x, n=None, increasing=False):
    a = _u(x)
    n = a.shape[0] if n is None else int(n)
    p = torch.arange(n, device=a.device)
    if not increasing:
        p = p.flip(0)
    return _w(a[:, None] ** p[None, :].to(a.dtype))


@_public
def block_diag(inputs):
    xs = [_u(a) for a in _seq(inputs)]
    xs = [a.reshape(1, -1) if a.dim() < 2 else a for a in xs]
    return _w(torch.block_diag(*xs))


# ---------------------------------------------------------------------------
# predicates / dtype helpers
# ---------------------------------------------------------------------------

@_public
def is_floating_point(x):
    return _u(x).is_floating_point()


@_public
def is_integer(x):
    d = _u(x).dtype
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


@_public
def is_complex(x):
    return _u(x).is_complex()


@_public
def isneginf(x):
    return _w(torch.isneginf(_u(x)))


@_public
def isposinf(x):
    return _w(torch.isposinf(_u(x)))


@_public
def isreal(x):
    return _w(torch.isreal(_u(x)))


@_public
def isin(x, test_x, assume_unique=False, invert=False):
    return _w(torch.isin(_u(x), _u(test_x), assume_unique=assume_unique,
                         invert=invert))


@_public
def signbit(x):
    return _w(torch.signbit(_u(x)))


@_public
def positive(x):
    if _u(x).dtype == torch.bool:
        raise TypeError("positive is not supported for bool tensors")
    return x


@_public
def neg(x):
    return OPS["scale"](x, -1.0)


@_public
def sgn(x):
    a = _u(x)
    if a.is_complex():
        return _w(torch.sgn(a))
    return OPS["sign"](x)


@_public
def sinc(x):
    return _w(torch.sinc(_u(x)))


class iinfo:
    def __init__(self, dtype):
        name = _dtype.DType(dtype).name
        info = torch.iinfo(_dtype.to_torch(name))
        self.min, self.max, self.bits = int(info.min), int(info.max), info.bits
        self.dtype = name


class finfo:
    def __init__(self, dtype):
        name = _dtype.DType(dtype).name
        info = torch.finfo(_dtype.to_torch(name))
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.bits = info.bits
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.smallest_normal)
        self.resolution = float(info.resolution)
        self.dtype = name


__all__ += ["iinfo", "finfo"]


# ---------------------------------------------------------------------------
# histograms / quantiles / distances / calculus helpers
# ---------------------------------------------------------------------------

@_public
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    # torch's right=False is numpy's side="left", as the reference's
    return _w(torch.bucketize(_u(x), _u(sorted_sequence),
                              out_int32=out_int32, right=right))


@_public
def histogram_bin_edges(x, bins=100, min=0.0, max=0.0):
    a = _u(x).reshape(-1)
    if min == 0.0 and max == 0.0:
        lo, hi = float(a.min()), float(a.max())
    else:
        lo, hi = float(min), float(max)
    if lo == hi:                       # numpy widens an empty range
        lo, hi = lo - 0.5, hi + 0.5
    return _w(torch.linspace(lo, hi, int(bins) + 1, dtype=a.dtype,
                             device=a.device))


@_public
def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    a = _u(x)
    rng = None if ranges is None else [float(v) for v in np.ravel(ranges)]
    h, edges = torch.histogramdd(
        a.reshape(-1, a.shape[-1]).cpu(), bins=bins, range=rng,
        density=density,
        weight=None if weights is None else _u(weights).reshape(-1).cpu())
    return _w(h.to(a.device)), [_w(e.to(a.device)) for e in edges]


@_public
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    a = _u(x)
    qq = _u(q).to(a.dtype) if isinstance(q, Tensor) else q
    if isinstance(qq, (list, tuple)):
        qq = torch.tensor(qq, dtype=a.dtype, device=a.device)
    if isinstance(axis, (list, tuple)):
        # several axes: move them last and flatten them, as numpy does
        axes = [d % a.dim() for d in axis]
        rest = [d for d in range(a.dim()) if d not in axes]
        b = a.permute(rest + axes).reshape(
            [a.shape[d] for d in rest] + [-1])
        out = torch.nanquantile(b, qq, dim=-1, interpolation=interpolation)
        if keepdim:
            for d in sorted(axes):
                out = out.unsqueeze(d + (out.dim() - len(rest)))
        return _w(out)
    return _w(torch.nanquantile(a, qq, dim=axis, keepdim=keepdim,
                                interpolation=interpolation))


def _pnorm(d, p):
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, dim=-1) + 0.0)
    if p == float("inf"):
        return torch.amax(torch.abs(d), dim=-1)
    return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)


@_public
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    a, b = _u(x), _u(y)
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        # the product form: O(n·m) memory in place of the O(n·m·k)
        # difference tensor
        a2 = torch.sum(a * a, dim=-1)[..., :, None]
        b2 = torch.sum(b * b, dim=-1)[..., None, :]
        ab = a @ b.transpose(-1, -2)
        return _w(torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)))
    return _w(_pnorm(a[..., :, None, :] - b[..., None, :, :], p))


@_public
def pdist(x, p=2.0):
    a = _u(x)
    iu = torch.triu_indices(a.shape[0], a.shape[0], 1, device=a.device)
    return _w(_pnorm(a[iu[0]] - a[iu[1]], p))


@_public
def diff(x, n=1, axis=-1, prepend=None, append=None):
    return _w(torch.diff(_u(x), n=n, dim=axis,
                         prepend=None if prepend is None else _u(prepend),
                         append=None if append is None else _u(append)))


@_public
def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return _w(torch.trapezoid(_u(y), x=_u(x), dim=axis))
    return _w(torch.trapezoid(_u(y), dx=1.0 if dx is None else dx, dim=axis))


@_public
def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    yy = torch.movedim(_u(y), axis, -1)
    if x is not None:
        xx = _u(x)
        if xx.dim() > 1:
            xx = torch.movedim(torch.broadcast_to(xx, _u(y).shape), axis, -1)
        widths = torch.diff(xx, dim=-1)
    else:
        widths = 1.0 if dx is None else dx
    out = torch.cumsum((yy[..., 1:] + yy[..., :-1]) / 2.0 * widths, dim=-1)
    return _w(torch.movedim(out, -1, axis))


@_public
def frexp(x):
    m, e = torch.frexp(_u(x))
    return _w(m), _w(e.to(torch.int32))


@_public
def polar(abs, angle):  # noqa: A002  (paddle's own argument name)
    return _w(torch.polar(_u(abs), _u(angle)))


@_public
def gammainc(x, y):
    return _w(torch.special.gammainc(_u(x), _u(y)))


@_public
def multigammaln(x, p):
    return _w(torch.special.multigammaln(_u(x), int(p)))


@_public
def take(x, index, mode="raise"):
    flat = _u(x).reshape(-1)
    idx = _u(index).long()
    n = flat.shape[0]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:      # "raise" and "clip" clip, as paddle's kernel does
        idx = torch.clamp(idx, -n, n - 1)
    return _w(flat[torch.where(idx < 0, idx + n, idx)])


# ---------------------------------------------------------------------------
# functional scatter / fill updates
# ---------------------------------------------------------------------------

@_public
def scatter_nd(index, updates, shape):
    zeros = OPS["zeros"](list(shape), updates.dtype
                         if hasattr(updates, "dtype") else None)
    return OPS["scatter_nd_add"](zeros, index, updates)


def _scattered(a, idx, v):
    out = a.clone()
    out[idx] = torch.broadcast_to(v.to(a.dtype), out[idx].shape)
    return out


@_public
def slice_scatter(x, value, axes, starts, ends, strides):
    a = _u(x)
    idx = [slice(None)] * a.dim()
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[ax] = slice(int(s), int(e), int(st))
    return _w(_scattered(a, tuple(idx), _u(value)))


@_public
def select_scatter(x, values, axis, index):
    a = _u(x)
    idx = [slice(None)] * a.dim()
    idx[axis] = int(index)
    return _w(_scattered(a, tuple(idx), _u(values)))


@_public
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    return _w(torch.diagonal_scatter(_u(x), _u(y).to(_u(x).dtype),
                                     offset=offset, dim1=axis1, dim2=axis2))


@_public
def index_fill(x, index, axis, value):
    a = _u(x)
    return _w(a.index_fill(axis, _u(index).long().to(a.device),
                           _u(value).to(a.dtype) if isinstance(value, Tensor)
                           else value))


@_public
def masked_scatter(x, mask, value):
    a, m, v = _u(x), _u(mask), _u(value).reshape(-1)
    m = torch.broadcast_to(m, a.shape)
    # the k-th True element takes value[k]: rank the Trues with a cumsum
    order = torch.cumsum(m.reshape(-1).to(torch.int64), 0) - 1
    picked = v[torch.clamp(order, 0, v.shape[0] - 1)].reshape(a.shape)
    return _w(torch.where(m, picked.to(a.dtype), a))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@_public
def standard_normal(shape, dtype=None, name=None):
    return OPS["gaussian"](list(shape), 0.0, 1.0, dtype)


@_public
def randint_like(x, low=0, high=None, dtype=None):
    if high is None:
        low, high = 0, low
    out = OPS["randint"](low, high, list(x.shape))
    return OPS["cast"](out, x.dtype if dtype is None else dtype)


@_public
def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    shape = [1] if shape is None else list(shape)
    return OPS["exp"](OPS["gaussian"](shape, float(mean), float(std), None))


# ---------------------------------------------------------------------------
# misc utilities
# ---------------------------------------------------------------------------

@_public
def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


@_public
def disable_signal_handler():
    """paddle's switch for its fatal-signal dumpers; the port installs
    none, so there is nothing to turn off."""


@_public
def check_shape(shape):
    """Validate a shape argument (paddle's utils/layers_utils.py:484)."""
    if isinstance(shape, Tensor):
        if shape.dtype not in ("int32", "int64"):
            raise TypeError("shape tensor must be int32/int64")
        return
    for ele in shape:
        if isinstance(ele, Tensor):
            continue
        if not isinstance(ele, (int, np.integer)):
            raise TypeError("All elements in `shape` must be integers")
        if ele < 0:
            raise ValueError("All elements in `shape` must be positive")


@_public
def batch(reader, batch_size, drop_last=False):
    """The legacy reader decorator: batches a reader's items into lists
    of `batch_size`."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


class LazyGuard:
    """paddle.LazyGuard: a context under which a model's parameters may
    be described before memory is committed. Parameters here are made
    when a Layer is built, so construction inside it is eager."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


__all__.append("LazyGuard")


@_public
def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from .. import nn
    from ..core.tensor import Parameter

    if default_initializer is None:
        default_initializer = (nn.initializer.Constant(0.0) if is_bias
                               else nn.initializer.XavierNormal())
    data = default_initializer(list(shape), dtype)
    p = Parameter(_u(data))
    if name:
        p.name = name
    return p


@_public
def from_dlpack(dlpack):
    import torch.utils.dlpack as _tdl
    return _w(_tdl.from_dlpack(dlpack))


@_public
def to_dlpack(x):
    import torch.utils.dlpack as _tdl
    return _tdl.to_dlpack(_u(x).detach())


# ---------------------------------------------------------------------------
# in-place functional spellings (`paddle.cos_(x)`) and method rebinds
# ---------------------------------------------------------------------------

# ops with an in-place spelling in paddle's __all__
_INPLACE_TAIL = [
    "cos", "sin", "tan", "sinh", "acos", "atan", "expm1", "erf", "log",
    "log2", "log10", "log1p", "trunc", "frac", "digamma", "lgamma",
    "gammaln", "cumsum", "cumprod", "logit", "neg", "i0", "polygamma",
    "nan_to_num", "square", "gcd", "lcm", "hypot", "copysign", "ldexp",
    "renorm", "addmm", "where", "equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "not_equal", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "floor_divide", "tril", "triu",
    "bitwise_left_shift", "bitwise_right_shift", "gammainc", "gammaincc",
    "multigammaln", "sinc", "scatter", "transpose", "t", "masked_scatter",
    "index_fill",
]
# the scatter-style ops and the rest of the trig tail
_INPLACE_MORE = ["acosh", "asin", "asinh", "atanh", "cosh",
                 "put_along_axis", "index_put"]

_LOCAL_BASES = {"neg": neg, "sinc": sinc, "multigammaln": multigammaln,
                "gammainc": gammainc, "t": t, "masked_scatter": masked_scatter,
                "index_fill": index_fill}


def _rebinding(f):
    def method(self, *args, **kwargs):
        return self._rebind(f(self, *args, **kwargs))
    return method


def _delegate(name):
    """`paddle.<name>(x, ...)`: the method `x.<name>(...)`."""
    def fn(x, *args, **kwargs):
        return getattr(x, name)(*args, **kwargs)
    fn.__name__ = fn.__qualname__ = name
    return fn


def _install_inplace(bases):
    for base in bases:
        fn = OPS.get(base) or _LOCAL_BASES.get(base)
        if fn is None:
            continue
        iname = base + "_"
        if not hasattr(Tensor, iname):
            setattr(Tensor, iname, _rebinding(fn))
        globals().setdefault(iname, _delegate(iname))
        if iname not in __all__:
            __all__.append(iname)


_install_inplace(_INPLACE_TAIL)


def where_(condition, x, y):
    """paddle.where_: the condition leads, x takes the result."""
    return x._rebind(OPS["where"](condition, x, y))


if "where_" in __all__:
    __all__.remove("where_")
__all__.append("where_")


def _draw(self, sample):
    """Rebind self to `sample(generator)`, a float32 draw of self's shape
    on self's device, cast to self's dtype."""
    a = self._data
    out = sample(_rng.next_generator(a.device))
    return self._rebind(_w(out.to(a.dtype)))


def _uniform01(self, gen, low=0.0):
    return torch.empty(self.shape, device=self._data.device).uniform_(
        low, 1.0, generator=gen)


def bernoulli_(self, p=0.5):
    return _draw(self, lambda g: (_uniform01(self, g) < p).float())


def cauchy_(self, loc=0, scale=1):
    return _draw(self, lambda g: loc + scale * torch.tan(
        _math.pi * (_uniform01(self, g) - 0.5)))


def geometric_(self, probs):
    return _draw(self, lambda g: torch.floor(
        torch.log(_uniform01(self, g, 1e-12))
        / _math.log1p(-float(probs))) + 1.0)


def log_normal_(self, mean=1.0, std=2.0):
    return _draw(self, lambda g: torch.exp(mean + std * torch.randn(
        self.shape, device=self._data.device, generator=g)))


for _fn in (bernoulli_, cauchy_, geometric_, log_normal_):
    if not hasattr(Tensor, _fn.__name__):
        setattr(Tensor, _fn.__name__, _fn)
    globals()[_fn.__name__] = _delegate(_fn.__name__)
    __all__.append(_fn.__name__)
del _fn


def _alias(name, target):
    globals()[name] = target
    __all__.append(name)


_alias("less", OPS["less_than"])
_alias("mod", OPS["remainder"])
_alias("floor_mod", OPS["remainder"])
_alias("bitwise_invert", OPS["bitwise_not"])
_alias("bitwise_invert_",
       lambda x, *a, **k: x._rebind(OPS["bitwise_not"](x, *a, **k)))
_alias("abs_", lambda x: x.abs_())
_alias("normal_", lambda x, mean=0.0, std=1.0: x.normal_(mean, std))

# module-level spellings of the method-only in-place variants (installed
# by tensor/__init__.py)
_METHOD_INPLACE = ["unsqueeze_", "squeeze_", "remainder_", "pow_", "divide_",
                   "cast_", "tanh_", "flatten_", "multiply_", "reshape_",
                   "masked_fill_", "add_", "subtract_", "scale_", "clip_",
                   "exp_", "sqrt_", "rsqrt_", "reciprocal_", "floor_",
                   "ceil_", "round_", "sigmoid_", "relu_", "erfinv_",
                   "lerp_", "index_add_", "zero_", "fill_", "uniform_",
                   "exponential_"]
for _mname in _METHOD_INPLACE:
    if _mname not in globals():
        _alias(_mname, _delegate(_mname))
del _mname
_alias("mod_", globals()["remainder_"])
_alias("floor_mod_", globals()["remainder_"])
_alias("less_", globals()["less_than_"])

__all__ += ["inf", "newaxis"]


class _OpaqueDType:
    """The reference's non-numeric dtypes (pstring: string tensors; raw:
    untyped buffers), as named sentinels."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"paddle.{self.name}"

    def __eq__(self, other):
        return (isinstance(other, _OpaqueDType) and other.name == self.name) \
            or other == self.name

    def __hash__(self):
        return hash(self.name)


pstring = _OpaqueDType("pstring")
raw = _OpaqueDType("raw")
__all__ += ["pstring", "raw"]


# ---------------------------------------------------------------------------
# linalg low-rank and factor helpers
# ---------------------------------------------------------------------------

@_public
def cholesky_inverse(x, upper=False):
    """A^-1 from A's Cholesky factor (A = L L^T, or U^T U)."""
    return _w(torch.cholesky_inverse(_u(x), upper=upper))


def _lowrank_svd(a, q, niter):
    """The Halko sketch with subspace iterations: (U, S, V), V by
    columns (a ~ U diag(S) V^T). The sketch's matrix is drawn from a
    generator of seed 0, as the reference draws it from PRNGKey(0)."""
    m, n = a.shape[-2], a.shape[-1]
    q = min(q, m, n)
    gen = torch.Generator(a.device).manual_seed(0)
    omega = torch.randn((*a.shape[:-2], n, q), generator=gen,
                        device=a.device, dtype=a.dtype)
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.transpose(-1, -2) @ y)
    qmat, _ = torch.linalg.qr(y)
    u_b, s, vt = torch.linalg.svd(qmat.transpose(-1, -2) @ a,
                                  full_matrices=False)
    return qmat @ u_b, s, vt.transpose(-1, -2)


@_public
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    a = _u(x)
    if M is not None:
        a = a - _u(M)
    return tuple(_w(v) for v in _lowrank_svd(a, q, niter))


@_public
def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The dense PCA sketch (the reference's `sparse.pca_lowrank` on a
    dense tensor; sparse inputs come with ROADMAP item 9)."""
    a = _u(x)
    if q is None:
        q = min(6, *a.shape)
    if center:
        a = a - a.mean(dim=0, keepdim=True)
    return tuple(_w(v) for v in _lowrank_svd(a, q, niter))


@_public
def ormqr(x, tau, y, left=True, transpose=False):
    """The product with Q of a QR factorization in householder form (the
    full m x m Q)."""
    return _w(torch.ormqr(_u(x), _u(tau), _u(y), left=left,
                          transpose=transpose))


@_public
def create_tensor(dtype, name=None, persistable=False):
    """An empty tensor of `dtype` (paddle.tensor.creation.create_tensor)."""
    return _w(torch.zeros((0,), dtype=_dtype.to_torch(dtype),
                          device=to_tensor(0).place.torch_device()))


_install_inplace(_INPLACE_MORE)


def set_(self, source=None, shape=None):
    """Tensor.set_: rebind this tensor to `source` (empty when None)."""
    if source is None:
        return self._rebind(_w(self._data.new_zeros((0,))))
    arr = _u(source)
    if shape is not None:
        arr = arr.reshape(shape)
    return self._rebind(_w(arr))


if not hasattr(Tensor, "set_"):
    Tensor.set_ = set_


# names of this module that are Tensor methods in the reference too
_METHOD_NAMES = [
    "atleast_1d", "atleast_2d", "atleast_3d", "bitwise_invert",
    "bitwise_invert_", "block_diag", "broadcast_shape", "bucketize",
    "cdist", "cholesky_inverse", "create_parameter", "create_tensor",
    "cumulative_trapezoid", "diagonal_scatter", "diff", "dsplit",
    "frexp", "gammainc", "histogram_bin_edges", "histogramdd", "hsplit",
    "index_fill", "is_complex", "is_floating_point", "is_integer",
    "isin", "isneginf", "isposinf", "isreal", "less", "less_",
    "masked_scatter", "mod_", "floor_mod_", "multigammaln",
    "nanquantile", "neg", "ormqr", "pca_lowrank", "polar", "scatter_nd",
    "select_scatter", "sgn", "signbit", "sinc", "slice_scatter",
    "svd_lowrank", "take", "tensor_split", "tensordot", "trapezoid",
    "unflatten", "vander", "view", "view_as", "vsplit",
]


def _istft(self, *args, **kwargs):
    raise NotImplementedError(
        "Tensor.istft is not ported yet: it comes with ROADMAP item 9, "
        "signal")


def _patch_methods():
    for name in _METHOD_NAMES:
        if not hasattr(Tensor, name):
            setattr(Tensor, name, globals().get(name) or OPS[name])
    if not hasattr(Tensor, "multi_dot"):
        Tensor.multi_dot = lambda self, *rest: OPS["multi_dot"](
            [self, *rest])
    if not hasattr(Tensor, "is_tensor"):
        Tensor.is_tensor = lambda self: True
    if not hasattr(Tensor, "istft"):
        Tensor.istft = _istft


_patch_methods()
