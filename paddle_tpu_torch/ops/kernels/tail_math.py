"""Op tail: math, norm, loss, quantization and optimizer-update ops —
port of `paddle_tpu/ops/kernels/tail_math.py`.

- math / norms: elementwise ops and reductions;
- losses: bce, hinge, kldiv, log, sigmoid-ce, margin-ce;
- quantization: the fake_quantize_* family and the weight-only int8
  linear; `llm_int8_linear`'s int8 product accumulates exactly (float64
  products of int8 values, the reference's int32 accumulation);
- optimizer updates (`sgd_`, `momentum_`, `adam_`, ...): functional, they
  return the updated tensors; the trailing underscore keeps the name.
"""
from __future__ import annotations

import math as _math

import torch
import torch.nn.functional as F

from ..dispatch import register_op
from ._util import axes


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else _math.sqrt(v)


# ---------------------------------------------------------------------------
# math / norms
# ---------------------------------------------------------------------------


@register_op
def copysign(x, y):
    return torch.copysign(x, y)


@register_op(nondiff=True)
def nextafter(x, y):
    return torch.nextafter(x, y)


@register_op
def gammaln(x):
    return torch.lgamma(x)


@register_op
def gammaincc(x, y):
    """Regularised upper incomplete gamma Q(x, y) (x the shape, y the
    point)."""
    return torch.special.gammaincc(x, y)


@register_op
def logcumsumexp(x, axis=-1, flatten=False):
    if flatten:
        x = x.reshape(-1)
        axis = 0
    return torch.logcumsumexp(x, dim=axis)


@register_op
def logsigmoid(x):
    return F.logsigmoid(x)


@register_op
def tanh_shrink(x):
    return x - torch.tanh(x)


@register_op
def dist(x, y, p=2.0):
    d = torch.abs(x - y)
    if p == 0:
        return (d != 0).sum().to(x.dtype)
    if _math.isinf(p):
        return d.max()
    return (d ** p).sum() ** (1.0 / p)


@register_op(nondiff=True)
def nanmedian(x, axis=None, keepdim=False):
    """The median ignoring NaNs, the mean of the two middle values for an
    even count (numpy's)."""
    if axis is None:
        out = torch.nanquantile(x.reshape(-1), 0.5)
        return out.reshape([1] * x.ndim) if keepdim else out
    dims = [a % x.ndim for a in (axis if isinstance(axis, (list, tuple))
                                 else [axis])]
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(*rest, *dims).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = torch.nanquantile(moved, 0.5, dim=-1)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.ndim)])
    return out


@register_op
def mean_all(x):
    return x.mean()


@register_op
def frobenius_norm(x, axis=None, keepdim=False):
    if axis is None:
        return torch.sqrt((x * x).sum())
    return torch.sqrt((x * x).sum(dim=axes(axis), keepdim=keepdim))


@register_op
def l1_norm(x):
    return x.abs().sum()


@register_op
def squared_l2_norm(x):
    return (x * x).sum()


@register_op
def clip_by_norm(x, max_norm):
    norm = torch.sqrt((x * x).sum())
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@register_op
def renorm(x, p, axis, max_norm):
    """Clamp the p-norm of each slice along `axis` to max_norm."""
    dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = (x.abs() ** p).sum(dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones((), dtype=x.dtype, device=x.device))
    return x * factor


@register_op
def label_smooth(label, prior_dist=None, epsilon=0.1):
    n = label.shape[-1]
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / n


@register_op(nondiff=True)
def bitwise_left_shift(x, y, is_arithmetic=True):
    return torch.bitwise_left_shift(x, y)


@register_op(nondiff=True)
def bitwise_right_shift(x, y, is_arithmetic=True):
    return torch.bitwise_right_shift(x, y)


@register_op(nondiff=True)
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@register_op
def increment(x, value=1.0):
    return x + value


@register_op
def rrelu(x, lower=0.125, upper=0.3333333333333333, is_test=False):
    """Randomized leaky relu at its mean slope (the test-mode rule)."""
    slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


@register_op
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


@register_op
def fused_softmax_mask(x, mask):
    """softmax(x + mask) over the last axis."""
    return torch.softmax(x + mask, dim=-1)


@register_op
def fused_softmax_mask_upper_triangle(x):
    """Causal softmax over the last axis."""
    T = x.shape[-1]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(causal, x, torch.full(
        (), -1e9, dtype=x.dtype, device=x.device)), dim=-1)


@register_op
def apply_per_channel_scale(x, scales):
    return x * scales


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@register_op
def bce_loss(input, label):
    x = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    return -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))


@register_op
def hinge_loss(logits, labels):
    """labels in {0, 1}, read as y' = 2y - 1."""
    y = 2.0 * labels - 1.0
    return torch.clamp(1.0 - y * logits, min=0.0)


@register_op
def log_loss(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


@register_op
def kldiv_loss(x, target, reduction="mean", log_target=False):
    """x is a log-probability, target a probability (or a log-probability
    with log_target)."""
    if log_target:
        out = torch.exp(target) * (target - x)
    else:
        t = torch.clamp(target, min=0.0)
        out = torch.where(target > 0,
                          target * (torch.log(torch.clamp(t, min=1e-12)) - x),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    if reduction == "batchmean":
        return out.sum() / x.shape[0]
    return out


@register_op
def sigmoid_cross_entropy_with_logits(x, label, normalize=False,
                                      ignore_index=-100):
    loss = torch.clamp(x, min=0.0) - x * label + torch.log1p(
        torch.exp(-x.abs()))
    valid = label != ignore_index
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    if normalize:
        loss = loss / torch.clamp(valid.sum(), min=1)
    return loss


@register_op
def identity_loss(x, reduction=1):
    """reduction 0 sum, 1 mean, 2 none."""
    if reduction == 0:
        return x.sum()
    if reduction == 1:
        return x.mean()
    return x


@register_op
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False):
    """ArcFace-family margin softmax on one shard."""
    n = logits.shape[-1]
    onehot = F.one_hot(label.long(), n).to(logits.dtype)
    cos = torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    adjusted = torch.where(onehot > 0, target, cos) * scale
    logp = torch.log_softmax(adjusted, dim=-1)
    loss = -(onehot * logp).sum(-1, keepdim=True)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _qmax(bits):
    return float(2 ** (bits - 1) - 1)


def _channel_shape(x, quant_axis):
    shape = [1] * x.ndim
    shape[quant_axis % x.ndim] = -1
    return shape


def _quant(x, scale, qmax):
    return torch.clamp(torch.round(x / scale * qmax), -qmax, qmax)


@register_op(nondiff=True)
def fake_quantize_abs_max(x, bit_length=8):
    """-> (quantized integers in float storage, scale)."""
    qmax = _qmax(bit_length)
    scale = torch.clamp(x.abs().max(), min=1e-8)
    return _quant(x, scale, qmax), scale


@register_op(nondiff=True)
def fake_dequantize_max_abs(x, scale, max_range):
    return x * scale / max_range


@register_op(nondiff=True)
def dequantize_abs_max(x, scale, max_range):
    return x.to(torch.float32) * scale / max_range


@register_op(nondiff=True)
def fake_channel_wise_quantize_abs_max(x, bit_length=8, quant_axis=0):
    qmax = _qmax(bit_length)
    dims = tuple(i for i in range(x.ndim) if i != quant_axis % x.ndim)
    scale = torch.clamp(x.abs().amax(dim=dims), min=1e-8)
    return _quant(x, scale.reshape(_channel_shape(x, quant_axis)), qmax), \
        scale


@register_op(nondiff=True)
def fake_channel_wise_dequantize_max_abs(x, scales, quant_bits=8,
                                         quant_axis=0):
    return x * scales.reshape(_channel_shape(x, quant_axis)) \
        / _qmax(quant_bits)


@register_op
def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8,
                                                  quant_axis=0):
    """Straight-through quantize-dequantize: the gradient passes through."""
    qmax = _qmax(bit_length)
    dims = tuple(i for i in range(x.ndim) if i != quant_axis % x.ndim)
    scale = torch.clamp(x.abs().amax(dim=dims, keepdim=True), min=1e-8)
    q = _quant(x, scale, qmax) * scale / qmax
    return x + (q - x).detach()


@register_op(nondiff=True)
def fake_quantize_moving_average_abs_max(x, in_scale, moving_rate=0.9,
                                         bit_length=8):
    """-> (q, out_scale), the scale an exponential moving average."""
    qmax = _qmax(bit_length)
    cur = x.abs().max()
    scale = torch.clamp(moving_rate * in_scale + (1 - moving_rate) * cur,
                        min=1e-8)
    return _quant(x, scale, qmax), scale


@register_op(nondiff=True)
def fake_quantize_dequantize_moving_average_abs_max(x, in_scale,
                                                    moving_rate=0.9,
                                                    bit_length=8):
    q, scale = fake_quantize_moving_average_abs_max._kernel(
        x, in_scale, moving_rate, bit_length)
    return q * scale / _qmax(bit_length), scale


@register_op(nondiff=True)
def fake_quantize_range_abs_max(x, in_scale, window_size=10000,
                                bit_length=8):
    qmax = _qmax(bit_length)
    scale = torch.clamp(torch.maximum(x.abs().max(), torch.as_tensor(
        in_scale, dtype=x.dtype, device=x.device)), min=1e-8)
    return _quant(x, scale, qmax), scale


@register_op(nondiff=True)
def weight_quantize(x, algo="weight_only_int8", arch=0, group_size=-1):
    """-> (int8 weight, scale a column); x is [in, out]."""
    scale = torch.clamp(x.abs().amax(dim=0), min=1e-8)
    q = torch.clamp(torch.round(x / scale[None, :] * 127.0), -127, 127)
    return q.to(torch.int8), (scale / 127.0).to(torch.float32)


@register_op(nondiff=True)
def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float32"):
    return x.to(torch.float32) * scale[None, :]


@register_op
def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=0, group_size=-1):
    """A float activation times an int8 weight, dequantized by column."""
    w = weight.to(x.dtype)
    if weight_scale is not None:
        w = w * weight_scale[None, :].to(x.dtype)
    out = torch.matmul(x, w)
    if bias is not None:
        out = out + bias
    return out


@register_op
def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0):
    """LLM.int8(): the outlier features (|x| > threshold anywhere) in
    float, the rest rounded to int8 and multiplied exactly."""
    absx = x.abs().amax(dim=tuple(range(x.ndim - 1)))
    outlier = absx > threshold
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_in = torch.where(outlier, zero, x)
    s_x = torch.clamp(x_in.abs().max(), min=1e-8)
    xq = torch.clamp(torch.round(x_in / s_x * 127.0), -127, 127)
    acc = torch.matmul(xq.to(torch.float64), weight.to(torch.float64))
    scale = weight_scale if weight_scale is not None else torch.ones(
        weight.shape[-1], dtype=torch.float32, device=x.device)
    main = acc.to(torch.float32) * (s_x / 127.0) * scale[None, :]
    x_out = torch.where(outlier, x, zero)
    out = main + torch.matmul(x_out, weight.to(torch.float32)
                              * scale[None, :])
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# optimizer updates (functional)
# ---------------------------------------------------------------------------


@register_op(name="sgd_", nondiff=True)
def sgd_(param, learning_rate, grad):
    return param - learning_rate * grad


@register_op(name="momentum_", nondiff=True)
def momentum_(param, grad, velocity, learning_rate, mu=0.9,
              use_nesterov=False):
    v = mu * velocity + grad
    if use_nesterov:
        return param - learning_rate * (grad + mu * v), v
    return param - learning_rate * v, v


@register_op(name="adam_", nondiff=True)
def adam_(param, grad, learning_rate, moment1, moment2, beta1_pow,
          beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-8):
    m1 = beta1 * moment1 + (1 - beta1) * grad
    m2 = beta2 * moment2 + (1 - beta2) * grad * grad
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    lr_t = learning_rate * _sqrt(1 - b2p) / (1 - b1p)
    return param - lr_t * m1 / (torch.sqrt(m2) + epsilon), m1, m2, b1p, b2p


@register_op(name="adamw_", nondiff=True)
def adamw_(param, grad, learning_rate, moment1, moment2, beta1_pow,
           beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-8,
           weight_decay=0.01, lr_ratio=1.0):
    p = param * (1 - learning_rate * lr_ratio * weight_decay)
    return adam_._kernel(p, grad, learning_rate * lr_ratio, moment1,
                         moment2, beta1_pow, beta2_pow, beta1, beta2,
                         epsilon)


@register_op(name="adagrad_", nondiff=True)
def adagrad_(param, grad, moment, learning_rate, epsilon=1e-6):
    m = moment + grad * grad
    return param - learning_rate * grad / (torch.sqrt(m) + epsilon), m


@register_op(name="adadelta_", nondiff=True)
def adadelta_(param, grad, avg_squared_grad, avg_squared_update,
              learning_rate=1.0, rho=0.95, epsilon=1e-6):
    g2 = rho * avg_squared_grad + (1 - rho) * grad * grad
    upd = (torch.sqrt(avg_squared_update + epsilon)
           / torch.sqrt(g2 + epsilon)) * grad
    u2 = rho * avg_squared_update + (1 - rho) * upd * upd
    return param - learning_rate * upd, g2, u2


@register_op(name="adamax_", nondiff=True)
def adamax_(param, grad, learning_rate, moment, inf_norm, beta1_pow,
            beta1=0.9, beta2=0.999, epsilon=1e-8):
    m = beta1 * moment + (1 - beta1) * grad
    n = torch.maximum(beta2 * inf_norm, grad.abs())
    return param - (learning_rate / (1 - beta1_pow)) * m / (n + epsilon), \
        m, n


@register_op(name="rmsprop_", nondiff=True)
def rmsprop_(param, mean_square, grad, moment, learning_rate,
             epsilon=1e-10, decay=0.9, momentum=0.0, centered=False,
             mean_grad=None):
    ms = decay * mean_square + (1 - decay) * grad * grad
    if centered:
        mg = decay * mean_grad + (1 - decay) * grad
        denom = torch.sqrt(ms - mg * mg + epsilon)
    else:
        denom = torch.sqrt(ms + epsilon)
    mom = momentum * moment + learning_rate * grad / denom
    if centered:
        return param - mom, ms, mom, mg
    return param - mom, ms, mom


@register_op(name="lamb_", nondiff=True)
def lamb_(param, grad, learning_rate, moment1, moment2, beta1_pow,
          beta2_pow, weight_decay=0.01, beta1=0.9, beta2=0.999,
          epsilon=1e-6):
    m1 = beta1 * moment1 + (1 - beta1) * grad
    m2 = beta2 * moment2 + (1 - beta2) * grad * grad
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + epsilon) \
        + weight_decay * param
    w_norm = torch.sqrt((param * param).sum())
    r_norm = torch.sqrt((r * r).sum())
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones((), dtype=w_norm.dtype,
                                   device=w_norm.device))
    return param - learning_rate * trust * r, m1, m2, b1p, b2p


@register_op(name="nadam_", nondiff=True)
def nadam_(param, grad, learning_rate, moment1, moment2, beta1_pow,
           beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-8):
    m1 = beta1 * moment1 + (1 - beta1) * grad
    m2 = beta2 * moment2 + (1 - beta2) * grad * grad
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    m1h = (beta1 * m1 + (1 - beta1) * grad) / (1 - b1p)
    m2h = m2 / (1 - b2p)
    return (param - learning_rate * m1h / (torch.sqrt(m2h) + epsilon),
            m1, m2, b1p, b2p)


@register_op(name="radam_", nondiff=True)
def radam_(param, grad, learning_rate, moment1, moment2, beta1_pow,
           beta2_pow, rho=None, beta1=0.9, beta2=0.999, epsilon=1e-8):
    m1 = beta1 * moment1 + (1 - beta1) * grad
    m2 = beta2 * moment2 + (1 - beta2) * grad * grad
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    rho_inf = 2.0 / (1 - beta2) - 1.0
    rho_t = rho_inf - 2.0 * b2p / (1 - b2p)
    m1h = m1 / (1 - b1p)
    r = torch.sqrt(torch.clamp(
        (rho_t - 4) * (rho_t - 2) * rho_inf
        / torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t, min=1e-12),
        min=0.0))
    adapted = torch.where(rho_t > 4.0,
                          r * m1h / (torch.sqrt(m2 / (1 - b2p)) + epsilon),
                          m1h)
    return param - learning_rate * adapted, m1, m2, b1p, b2p


@register_op(name="asgd_", nondiff=True)
def asgd_(param, grad, learning_rate, d, y, n):
    """d and y the running aggregates, n the window."""
    d2 = d - y + grad
    return param - (learning_rate / n) * d2, d2, grad


@register_op(name="ftrl_", nondiff=True)
def ftrl_(param, squared_accum, linear_accum, grad, learning_rate,
          l1=0.0, l2=0.0, lr_power=-0.5):
    """FTRL-proximal, with l1 and l2 shifted by 1e-10 as the reference's
    kernel shifts them."""
    l1 = l1 + 1e-10
    l2 = l2 + 1e-10
    new_sq = squared_accum + grad * grad
    sigma = (new_sq ** (-lr_power) - squared_accum ** (-lr_power)) \
        / learning_rate
    lin = linear_accum + grad - sigma * param
    quad = new_sq ** (-lr_power) / learning_rate + 2.0 * l2
    p = torch.where(lin.abs() > l1, (torch.sign(lin) * l1 - lin) / quad,
                    torch.zeros((), dtype=lin.dtype, device=lin.device))
    return p, new_sq, lin
