"""auto_cast: the per-op dtype policy, applied in the port's `call_op`.

Port of `paddle_tpu/amp/auto_cast.py`. The white list (`:20`) runs in
the AMP dtype, the black list (`:24`) in float32, everything else in
whatever type arrives (O1) or in the AMP dtype (O2). The cast is
`Tensor.to` on each floating torch tensor among an op's arguments, so
autograd carries the gradient back through it. The hook is installed in
`ops.dispatch` only while some `auto_cast` is open, so an op outside AMP
pays one check for it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core import dtype as dtype_mod
from ..ops import dispatch

__all__ = ["white_list", "black_list", "auto_cast", "amp_guard",
           "amp_pre_dispatch", "amp_state", "decorate", "last_amp_dtype"]

# O1 lists: the reference's (python/paddle/amp/amp_lists.py, in this
# framework's op names)
white_list = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "addmm", "scaled_dot_product_attention",
}
black_list = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "reciprocal", "rsqrt", "softmax_with_cross_entropy", "nll_loss",
    "bce_with_logits", "kl_div", "cross_entropy", "logsumexp", "log_softmax",
    "cumsum", "cumprod", "norm", "p_norm", "var", "std",
    "sum", "mean",
    "layer_norm", "rms_norm", "batch_norm_train", "batch_norm_infer",
    "group_norm", "instance_norm", "softmax",
}

_EXEMPT = {"cast", "assign", "getitem", "setitem", "zeros_like", "ones_like",
           "full_like"}

_tls = threading.local()
_open = [0]                  # auto_cast contexts open, all threads
_lock = threading.Lock()


class _AmpState:
    __slots__ = ("enable", "dtype", "torch_dtype", "level", "white", "black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.torch_dtype = dtype_mod.to_torch(dtype)
        self.level = level
        self.white = white
        self.black = black


def _current():
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def amp_state():
    """The innermost open auto_cast of this thread, or None."""
    return _current()


def last_amp_dtype():
    """The dtype of the last auto_cast this thread entered (None before
    any): how a GradScaler tells bfloat16 training from float16."""
    return getattr(_tls, "last", None)


def _cast(x, to):
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and x.dtype != to:
            return x.to(to)
        return x
    if isinstance(x, list):
        return [_cast(v, to) for v in x]
    if isinstance(x, tuple):
        out = [_cast(v, to) for v in x]
        return tuple(out) if type(x) is tuple else type(x)(*out)
    if isinstance(x, dict):
        return {k: _cast(v, to) for k, v in x.items()}
    return x


def amp_pre_dispatch(op_name, args, kwargs):
    """The AMP cast hook: args and kwargs (torch tensors) cast by the
    innermost auto_cast's policy for `op_name`."""
    st = _current()
    if st is None or not st.enable or op_name in _EXEMPT:
        return args, kwargs
    if op_name in st.white or (st.level == "O2"
                               and op_name not in st.black):
        to = st.torch_dtype
    elif op_name in st.black:
        to = torch.float32
    else:
        return args, kwargs
    return _cast(args, to), _cast(kwargs, to)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast: ops dispatched inside run under the O1 or O2
    policy in `dtype` (float16 or bfloat16)."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level should be O0/O1/O2, got {level}")
    if dtype not in ("float16", "bfloat16"):
        raise ValueError(f"amp dtype must be float16 or bfloat16, got {dtype}")
    white = set(white_list) | set(custom_white_list or ())
    black = ((set(black_list) | set(custom_black_list or ()))
             - set(custom_white_list or ()))
    st = _AmpState(enable and level != "O0", dtype, level, white, black)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(st)
    if st.enable:
        _tls.last = dtype
    with _lock:
        _open[0] += 1
        dispatch.set_amp_hook(amp_pre_dispatch)
    try:
        yield
    finally:
        stack.pop()
        with _lock:
            _open[0] -= 1
            if not _open[0]:
                dispatch.set_amp_hook(None)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """paddle.amp.decorate: for O2, cast the models' floating parameters
    to `dtype`, except in norm layers and `excluded_layers`."""
    from ..nn.layer.layers import Layer
    from ..nn.layer.norm import LayerNorm, _BatchNormBase

    single = isinstance(models, Layer)
    model_list = [models] if single else list(models)
    if level == "O2":
        keep = (_BatchNormBase, LayerNorm) + tuple(excluded_layers or ())
        to = dtype_mod.to_torch(dtype)
        for m in model_list:
            for layer in m.sublayers(include_self=True):
                if isinstance(layer, keep):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p._data.is_floating_point():
                        p._data = p._data.detach().to(to).requires_grad_(
                            p._data.requires_grad)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
