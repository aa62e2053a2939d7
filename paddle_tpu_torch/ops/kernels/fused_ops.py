"""Fused ops: the GEMM epilogues and the elementwise + activation family.

Counterpart of the GEMM-epilogue section and the elementwise family of
`paddle_tpu/ops/kernels/fused_ops.py` (`_ACTS` :41, `fc` :67,
`gemm_epilogue` :82, `fused_linear_param_grad_add` :110,
`fused_bias_act` :129, `_bcast_axis` :159, `fused_elementwise_*` :178,
`fused_elemwise_add_activation` :206). Plain functions on
`torch.Tensor`s; autograd is torch's.

Routing mirrors the reference's, less its `FLAGS_pallas_ffn` gate (on
the card it could only turn the kernels off):
- `gemm_epilogue`, untransposed, with a 2-D `y`, a bias of shape [n] or
  none, an activation in A8's set and f32/bf16 operands of one type, runs
  kernel A8 (`ops/cuda/fused_ffn.py` `fused_gemm_epilogue`);
- `fused_bias_act`'s gated modes (`swiglu`, `geglu`) add the bias, then run
  kernel A9 (`fused_glu`) on the two halves of the last axis as views;
- everything else is the stock composition, on any device.
A kernel wrapper runs its plain version for CPU tensors.

The rest of the reference file (norm, attention, conv and RNN fusions,
the dropout ops) waits for the op library and the RNG.
"""
from __future__ import annotations

import math

import torch

from ..cuda import fused_ffn as _ff
from ..dispatch import register_op

F = torch.nn.functional

__all__ = ["fc", "gemm_epilogue", "fused_linear_param_grad_add",
           "fused_bias_act", "fused_elementwise_add", "fused_elementwise_sub",
           "fused_elementwise_mul", "fused_elementwise_div",
           "fused_elemwise_add_activation"]


def _identity(x):
    return x


# jax.nn.gelu is the tanh form; jax.nn.leaky_relu's slope is 0.01, as
# torch's
_ACTS = {
    "": _identity, "identity": _identity, "none": _identity,
    "relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "silu": F.silu,
    "swish": F.silu, "leaky_relu": F.leaky_relu,
}


def _act(name):
    fn = _ACTS.get((name or "").lower())
    if fn is None:
        raise ValueError(f"unknown activation {name!r}")
    return fn


# ---------------------------------------------------------------------------
# GEMM epilogues
# ---------------------------------------------------------------------------


@register_op
def fc(input, w, bias=None, in_num_col_dims=1, activation_type="",
       padding_weights=False):
    """fused fc: flatten the leading `in_num_col_dims` axes -> matmul ->
    bias -> activation."""
    lead = tuple(input.shape[:in_num_col_dims])
    x2 = input.reshape(math.prod(lead), -1)
    out = x2 @ w
    if bias is not None:
        out = out + bias
    out = _act(activation_type)(out)
    return out.reshape(lead + (w.shape[-1],))


@register_op
def gemm_epilogue(x, y, bias=None, trans_x=False, trans_y=False,
                  activation="none"):
    """act(x @ y + bias). Untransposed shapes with a 2-D y, a bias [n] or
    none, an activation in A8's set and f32/bf16 operands of one type run
    kernel A8 over the rows of x; everything else is the stock
    composition."""
    a = x.transpose(-1, -2) if trans_x else x
    b = y.transpose(-1, -2) if trans_y else y
    if (not trans_x and not trans_y and a.dim() >= 2 and b.dim() == 2
            and a.shape[-1] == b.shape[0] and b.dtype == a.dtype
            and (bias is None or tuple(bias.shape) == (b.shape[1],))):
        m = math.prod(a.shape[:-1])
        k, n = b.shape
        if _ff.epilogue_supported(m, k, n, activation, a.dtype):
            out = _ff.fused_gemm_epilogue(a.reshape(m, k), b, bias,
                                          activation)
            return out.reshape(a.shape[:-1] + (n,))
    out = a @ b
    if bias is not None:
        out = out + bias
    return _act(activation)(out)


@register_op
def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True, has_bias=True):
    """A linear layer's parameter gradients in one pass: dW += xᵀ dout,
    db += Σ dout (accumulated in f32 under multi_precision)."""
    x2 = x.reshape(-1, x.shape[-1])
    d2 = dout.reshape(-1, dout.shape[-1])
    acc_t = torch.float32 if multi_precision else x2.dtype
    dw = x2.t().to(acc_t) @ d2.to(acc_t)
    if dweight is not None:
        dw = dweight + dw.to(dweight.dtype)
    if not has_bias:
        return dw
    db = d2.to(acc_t).sum(0)
    if dbias is not None:
        db = dbias + db.to(dbias.dtype)
    return dw, db


@register_op
def fused_bias_act(x, bias=None, act_method="gelu"):
    """Bias add + activation; the gated modes (`swiglu`, `geglu`) split
    the last axis in halves u | v and return act(u) * v through kernel A9,
    which reads the halves in place."""
    if bias is not None:
        x = x + bias
    m = (act_method or "").lower()
    if m in ("geglu", "swiglu"):
        act = "gelu" if m == "geglu" else "silu"
        if x.shape[-1] % 2:
            raise ValueError(f"{m} splits the last axis in halves; got "
                             f"{x.shape[-1]}")
        f = x.shape[-1] // 2
        rows = math.prod(x.shape[:-1])
        if _ff.glu_supported(rows, f, act, x.dtype):
            x2 = x.reshape(rows, 2 * f)
            out = _ff.fused_glu(x2[:, :f], x2[:, f:], act)
            return out.reshape(x.shape[:-1] + (f,))
        u, v = x.chunk(2, dim=-1)
        return _act(act)(u) * v
    return _act(m)(x)


# ---------------------------------------------------------------------------
# elementwise + activation family
# ---------------------------------------------------------------------------


def _bcast_axis(x, y, axis):
    """Paddle's legacy axis-broadcast: align y's dims with x starting at
    `axis` (trailing dims of size 1 appended)."""
    ny = y.dim() if torch.is_tensor(y) else 0
    if axis in (-1, None) or ny in (0, x.dim()):
        return y
    pad = x.dim() - axis - ny
    return y.reshape(tuple(y.shape) + (1,) * pad)


def _fused_unary(name, alpha):
    # alpha=None selects the activation's default; an explicit 0.0 is
    # honored (zero-slope leaky_relu == relu)
    if (name or "").lower() == "leaky_relu":
        slope = 0.01 if alpha is None else alpha
        return lambda v: F.leaky_relu(v, slope)
    return _act(name)


@register_op
def fused_elementwise_add(x, y, axis=-1, fuse_alpha=None, fuse_beta=None,
                          fused_unary_fn="identity"):
    return _fused_unary(fused_unary_fn, fuse_alpha)(
        x + _bcast_axis(x, y, axis))


@register_op
def fused_elementwise_sub(x, y, axis=-1, fuse_alpha=None,
                          fused_unary_fn="identity"):
    return _fused_unary(fused_unary_fn, fuse_alpha)(
        x - _bcast_axis(x, y, axis))


@register_op
def fused_elementwise_mul(x, y, axis=-1, fuse_alpha=None,
                          fused_unary_fn="identity"):
    return _fused_unary(fused_unary_fn, fuse_alpha)(
        x * _bcast_axis(x, y, axis))


@register_op
def fused_elementwise_div(x, y, axis=-1, fuse_alpha=None,
                          fused_unary_fn="identity"):
    return _fused_unary(fused_unary_fn, fuse_alpha)(
        x / _bcast_axis(x, y, axis))


@register_op
def fused_elemwise_add_activation(x, y, functor_list=("elementwise_add",
                                                      "relu"), axis=-1,
                                  scale=1.0, save_intermediate_out=False):
    """f(x + y), f the unary functors of `functor_list` in order
    ("scale" multiplies by `scale`)."""
    unary = [f for f in functor_list if not f.startswith("elementwise")]
    out = x + y
    for f in unary:
        out = _act(f.replace("scale", "identity"))(out) * (
            scale if f == "scale" else 1.0)
    if save_intermediate_out:
        return out, x + y
    return out
