"""Neural-net kernels: port of `paddle_tpu/ops/kernels/nn_ops.py`.

Activations, dropout, embedding, linear, convolution, pooling, the
normalizations, the losses, attention and the vision resamplers, each a
torch op or a short composition (convolutions and pooling run the
library's kernels on the card; the reference has no Pallas kernel in
this module). Layouts are paddle's: conv weights [out, in/groups, *k],
linear weights [in, out], attention [batch, seq, heads, head_dim].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...core import rng
from ...incubate.nn.functional import swiglu  # noqa: F401  (the op "swiglu")
from ..dispatch import register_op
from ._util import pair


# ---- activations -----------------------------------------------------------
@register_op
def relu(x):
    return torch.relu(x)


@register_op
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@register_op
def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


@register_op
def prelu(x, weight):
    return torch.where(x >= 0, x, weight * x)


@register_op
def elu(x, alpha=1.0):
    return F.elu(x, alpha)


@register_op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op
def celu(x, alpha=1.0):
    return F.celu(x, alpha)


@register_op
def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register_op
def silu(x):
    return F.silu(x)


@register_op
def swish(x):
    return F.silu(x)


@register_op
def mish(x):
    return x * torch.tanh(F.softplus(x))


@register_op
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@register_op
def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@register_op
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@register_op
def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@register_op
def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@register_op
def tanhshrink(x):
    return x - torch.tanh(x)


@register_op
def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(x * beta > threshold, x,
                       F.softplus(x * beta) / beta)


@register_op
def softsign(x):
    return x / (1.0 + torch.abs(x))


@register_op
def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@register_op
def log_sigmoid(x):
    return F.logsigmoid(x)


@register_op
def softmax(x, axis=-1):
    return torch.softmax(x, axis)


@register_op
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, axis)


def _uniform(shape, like, lo, hi, gen):
    u = torch.rand(shape, generator=gen, device=like.device,
                   dtype=like.dtype if like.is_floating_point()
                   else torch.float32)
    return lo + (hi - lo) * u


@register_op
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    u = _uniform(x.shape, x, 1e-20, 1.0, rng.next_generator(x.device))
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        y_hard = (y == torch.amax(y, axis, keepdim=True)).to(y.dtype)
        y = (y_hard - y).detach() + y
    return y


@register_op
def maxout(x, groups, axis=1):
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), axis + 1)


@register_op
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


# ---- dropout ---------------------------------------------------------------
@register_op
def dropout(x, p=0.5, training=True, mode="upscale_in_train", seed=0):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    gen = rng.seed_or_next(seed, x.device)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    zero = torch.zeros_like(x)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, zero)
    return torch.where(mask, x, zero)


# ---- embedding -------------------------------------------------------------
@register_op
def embedding(x, weight, padding_idx=None, sparse=False):
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx = weight.shape[0] + padding_idx
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


# ---- linear ----------------------------------------------------------------
@register_op
def linear(x, weight, bias=None):
    """x @ weight (+ bias), weight [in, out] as paddle stores it."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


# ---- conv ------------------------------------------------------------------
_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _to_first(x, nd):
    return x.permute(0, nd + 1, *range(1, nd + 1))


def _to_last(x, nd):
    return x.permute(0, *range(2, nd + 2), 1)


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's SAME: output ceil(in / stride), the extra pad on the high side."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, data_format,
             nd):
    stride, dilation = pair(stride, nd), pair(dilation, nd)
    last = data_format in _CHANNEL_LAST
    if last:
        x = _to_first(x, nd)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0)] * nd
        else:
            pads = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    else:
        p = pair(padding, nd)
        pads = ([(int(v), int(v)) for v in p] if len(p) == nd else
                [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(nd)])
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    if all(lo == hi for lo, hi in pads):
        out = conv(x, weight, bias, stride, [lo for lo, _ in pads], dilation,
                   groups)
    else:
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        out = conv(F.pad(x, flat), weight, bias, stride, 0, dilation, groups)
    return _to_last(out, nd) if last else out


@register_op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


@register_op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


@register_op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


@register_op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """weight [in, out/groups, kh, kw], as paddle and torch store it."""
    last = data_format == "NHWC"
    if last:
        x = _to_first(x, 2)
    out = F.conv_transpose2d(x, weight, bias, pair(stride), pair(padding),
                             pair(output_padding), groups, pair(dilation))
    return _to_last(out, 2) if last else out


# ---- pooling ---------------------------------------------------------------
def _pool_pads(sizes, kernel, stride, padding, ceil_mode):
    """(low, high) pads a spatial dim: the reference's rule, with extra
    high-side padding under ceil_mode so the last partial window counts."""
    pads = []
    for n, k, s, p in zip(sizes, kernel, stride, padding):
        hi = p
        if ceil_mode:
            size = n + 2 * p
            hi += (-(-(size - k) // s) - (size - k) // s) * s
        pads.append((p, hi))
    return pads


def _pool(x, kernel, stride, padding, data_format, kind, nd, ceil_mode):
    """Max or window-sum pooling over padded input ("max": -inf padding,
    "sum": zero padding)."""
    kernel = pair(kernel, nd)
    stride = pair(stride if stride is not None else kernel, nd)
    last = data_format in _CHANNEL_LAST
    if last:
        x = _to_first(x, nd)
    pads = _pool_pads(x.shape[2:], kernel, stride, pair(padding, nd),
                      ceil_mode)
    if any(lo or hi for lo, hi in pads):
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        x = F.pad(x, flat, value=float("-inf") if kind == "max" else 0.0)
    if kind == "max":
        out = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1](
            x, kernel, stride)
    else:
        area = math.prod(kernel)
        out = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd - 1](
            x, kernel, stride) * area
    return _to_last(out, nd) if last else out


@register_op
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, data_format, "max", 2,
                 ceil_mode)


@register_op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    kernel = pair(kernel_size, 2)
    summed = _pool(x, kernel_size, stride, padding, data_format, "sum", 2,
                   ceil_mode)
    if exclusive and pair(padding, 2) != [0, 0]:
        counts = _pool(torch.ones_like(x), kernel_size, stride, padding,
                       data_format, "sum", 2, ceil_mode)
        return summed / counts
    return summed / (kernel[0] * kernel[1])


@register_op
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCL"):
    return _pool(x, kernel_size, stride, padding, data_format, "max", 1,
                 ceil_mode)


@register_op
def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCL"):
    summed = _pool(x, kernel_size, stride, padding, data_format, "sum", 1,
                   ceil_mode)
    return summed / pair(kernel_size, 1)[0]


@register_op
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    if data_format == "NHWC":
        return _to_last(F.adaptive_avg_pool2d(_to_first(x, 2),
                                              pair(output_size)), 2)
    return F.adaptive_avg_pool2d(x, pair(output_size))


@register_op
def adaptive_avg_pool1d(x, output_size):
    out = output_size if isinstance(output_size, int) else output_size[0]
    return F.adaptive_avg_pool1d(x, out)


@register_op
def adaptive_max_pool1d(x, output_size, return_mask=False):
    out = output_size if isinstance(output_size, int) else output_size[0]
    return F.adaptive_max_pool1d(x, out, return_indices=return_mask)


@register_op
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return F.adaptive_avg_pool3d(x, pair(output_size, 3))


@register_op
def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW"):
    return F.adaptive_max_pool3d(x, pair(output_size, 3),
                                 return_indices=return_mask)


@register_op
def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return F.adaptive_max_pool2d(x, pair(output_size))


# ---- normalization ---------------------------------------------------------
def _affine(out, weight, bias, shape=None):
    if weight is not None:
        out = out * (weight if shape is None else weight.reshape(shape))
    if bias is not None:
        out = out + (bias if shape is None else bias.reshape(shape))
    return out


@register_op
def layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=-1):
    dims = tuple(range(begin_norm_axis % x.dim(), x.dim())) \
        if begin_norm_axis != -1 else (-1,)
    mean = torch.mean(x, dims, keepdim=True)
    var = torch.mean(torch.square(x - mean), dims, keepdim=True)
    return _affine((x - mean) * torch.rsqrt(var + epsilon), weight, bias)


@register_op
def rms_norm(x, weight=None, bias=None, epsilon=1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), -1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine(out, weight, bias)


def _bn_layout(x, data_format):
    if data_format in ("NCHW", "NCL", "NCDHW") and x.dim() > 2:
        return (0,) + tuple(range(2, x.dim())), (1, -1) + (1,) * (x.dim() - 2)
    return tuple(range(x.dim() - 1)), (1,) * (x.dim() - 1) + (-1,)


@register_op
def batch_norm_infer(x, mean, variance, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    _, shape = _bn_layout(x, data_format)
    out = (x - mean.reshape(shape)) * torch.rsqrt(
        variance.reshape(shape) + epsilon)
    return _affine(out, weight, bias, shape)


@register_op
def batch_norm_train(x, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    """(out, batch mean, batch var); the layer updates running stats."""
    dims, shape = _bn_layout(x, data_format)
    mean = torch.mean(x, dims)
    var = torch.mean(torch.square(x), dims) - torch.square(mean)
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    return _affine(out, weight, bias, shape), mean, var


@register_op
def group_norm(x, weight=None, bias=None, epsilon=1e-5, groups=1,
               data_format="NCHW"):
    if data_format == "NCHW":
        N, C = x.shape[:2]
        xg = x.reshape((N, groups, C // groups) + tuple(x.shape[2:]))
        dims = tuple(range(2, xg.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        N, C = x.shape[0], x.shape[-1]
        xg = x.reshape((N,) + tuple(x.shape[1:-1]) + (groups, C // groups))
        dims = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        shape = (1,) * (x.dim() - 1) + (-1,)
    mean = torch.mean(xg, dims, keepdim=True)
    var = torch.var(xg, dims, correction=0, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias, shape)


@register_op
def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    dims = tuple(range(2, x.dim()))
    mean = torch.mean(x, dims, keepdim=True)
    var = torch.var(x, dims, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    return _affine(out, weight, bias, (1, -1) + (1,) * (x.dim() - 2))


@register_op
def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    c = 1 if data_format == "NCHW" else x.dim() - 1
    half = size // 2
    sq = torch.movedim(torch.square(x), c, -1)
    sq = F.pad(sq, (half, size - 1 - half))
    s = torch.movedim(sq.unfold(-1, size, 1).sum(-1), -1, c)
    return x / torch.pow(k + alpha * s, beta)


# ---- losses ----------------------------------------------------------------
@register_op
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1):
    logp = torch.log_softmax(logits, axis)
    if soft_label:
        return -torch.sum(label * logp, axis, keepdim=True)
    lbl = label.long()
    if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    idx = torch.clamp(lbl, min=0).unsqueeze(axis)
    nll = -torch.gather(logp, axis % logits.dim(), idx)
    mask = (lbl != ignore_index).unsqueeze(axis)
    return torch.where(mask, nll, torch.zeros_like(nll))


@register_op
def nll_loss(logp, label, weight=None, ignore_index=-100, reduction="mean"):
    lbl = label.long()
    safe = torch.clamp(lbl, min=0)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    mask = lbl != ignore_index
    if weight is not None:
        w = weight[safe]
        nll = nll * w
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    if reduction == "mean":
        denom = torch.sum(w * mask) if weight is not None \
            else torch.sum(mask).to(nll.dtype)
        return torch.sum(nll) / torch.clamp(denom, min=1)
    if reduction == "sum":
        return torch.sum(nll)
    return nll


@register_op
def bce_with_logits(logit, label, weight=None, pos_weight=None):
    max_val = torch.clamp(-logit, min=0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1.0 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1.0 - label) * logit + max_val + soft
    if weight is not None:
        loss = loss * weight
    return loss


@register_op
def kl_div(x, target, reduction="mean", log_target=False):
    if log_target:
        loss = torch.exp(target) * (target - x)
    else:
        loss = target * (torch.log(torch.clamp(target, min=1e-30)) - x)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "batchmean":
        return torch.sum(loss) / x.shape[0]
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@register_op
def huber_loss(input, label, delta=1.0):
    d = input - label
    ad = torch.abs(d)
    return torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))


# ---- attention -------------------------------------------------------------
@register_op
def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None):
    """[batch, seq, heads, head_dim] in and out, as paddle lays it out."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[3]
    scale = scale or (1.0 / math.sqrt(D))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    neg = torch.full_like(logits, float("-inf"))
    if is_causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, neg)
    if attn_mask is not None:
        logits = (torch.where(attn_mask, logits, neg)
                  if attn_mask.dtype == torch.bool else logits + attn_mask)
    probs = torch.softmax(logits, -1)
    if dropout_p > 0.0 and training:
        keep = 1.0 - dropout_p
        gen = rng.next_generator(q.device)
        probs = probs * (torch.rand(probs.shape, generator=gen,
                                    device=q.device) < keep) / keep
    return torch.matmul(probs, vh).transpose(1, 2)


# ---- vision ----------------------------------------------------------------
def _nearest_index(n_out, n_in, dev):
    return torch.div(torch.arange(n_out, device=dev) * n_in, n_out,
                     rounding_mode="floor")


@register_op
def interpolate_nearest(x, out_hw, data_format="NCHW"):
    chan_first = data_format == "NCHW"
    H, W = (x.shape[2], x.shape[3]) if chan_first else (x.shape[1], x.shape[2])
    rows = _nearest_index(out_hw[0], H, x.device)
    cols = _nearest_index(out_hw[1], W, x.device)
    if chan_first:
        return x[:, :, rows[:, None], cols[None, :]]
    return x[:, rows[:, None], cols[None, :], :]


@register_op
def interpolate_bilinear(x, out_hw, align_corners=False, data_format="NCHW"):
    chan_first = data_format == "NCHW"
    if chan_first:
        x = torch.movedim(x, 1, -1)
    H, W = x.shape[1], x.shape[2]
    oh, ow = out_hw
    dev, dt = x.device, x.dtype

    def coords(n_out, n_in):
        if align_corners and n_out > 1:
            c = torch.linspace(0, n_in - 1, n_out, device=dev)
        else:
            c = (torch.arange(n_out, device=dev) + 0.5) * n_in / n_out - 0.5
        return torch.clamp(c, 0, n_in - 1)

    ys, xs = coords(oh, H), coords(ow, W)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0).to(dt)[None, :, None, None]
    wx = (xs - x0).to(dt)[None, None, :, None]
    p00 = x[:, y0[:, None], x0[None, :], :]
    p01 = x[:, y0[:, None], x1[None, :], :]
    p10 = x[:, y1[:, None], x0[None, :], :]
    p11 = x[:, y1[:, None], x1[None, :], :]
    out = (p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx
           + p10 * wy * (1 - wx) + p11 * wy * wx)
    return torch.movedim(out, -1, 1) if chan_first else out


@register_op
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        return F.pixel_shuffle(x, r)
    N, H, W, C = x.shape
    x = x.reshape(N, H, W, r, r, C // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(N, H * r, W * r, C // (r * r))


