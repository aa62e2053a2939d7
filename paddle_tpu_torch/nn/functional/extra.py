"""The tail of nn.functional: port of
`paddle_tpu/nn/functional/extra.py`, star-imported at the end of
`nn/functional/__init__.py`.

Op re-exports, the pooling, unpooling and `conv1d_transpose` wrappers,
the dropout variants, the fourteen loss compositions (`dice_loss` ...
`adaptive_log_softmax_with_loss`, `rnnt_loss`) and the in-place
activation spellings, built on the port's registered ops as the
reference builds them on its own. The packed flash-attention wrappers
run kernel A1 (A2 under autograd): `flash_attn_qkvpacked` through the
registered `flash_attn` on [B, S, H, D], `flash_attn_varlen_qkvpacked`
through `flash_attn_unpadded`'s segment-id mode when the two packings
are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import _C_ops
from ...core.tensor import Tensor
from ...ops.dispatch import OPS

__all__ = [
    # op re-exports
    "bilinear", "class_center_sample", "flashmask_attention", "fold",
    "fractional_max_pool2d", "fractional_max_pool3d", "gather_tree",
    "hsigmoid_loss", "label_smooth", "log_loss", "lp_pool2d",
    "margin_cross_entropy", "rrelu", "sequence_mask", "sparse_attention",
    "adaptive_avg_pool1d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool3d",
    # wrappers / compositions
    "avg_pool3d", "max_pool3d", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "lp_pool1d", "conv1d_transpose", "zeropad2d",
    "alpha_dropout", "feature_alpha_dropout", "dropout3d", "dice_loss",
    "npair_loss", "pairwise_distance", "cosine_embedding_loss",
    "gaussian_nll_loss", "hinge_embedding_loss",
    "multi_label_soft_margin_loss", "multi_margin_loss",
    "poisson_nll_loss", "soft_margin_loss", "sigmoid_focal_loss",
    "triplet_margin_loss", "triplet_margin_with_distance_loss",
    "rnnt_loss", "adaptive_log_softmax_with_loss",
    "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
    # in-place activation spellings
    "elu_", "hardtanh_", "leaky_relu_", "relu_", "softmax_", "tanh_",
    "thresholded_relu_",
]

# -- op re-exports -----------------------------------------------------------
bilinear = _C_ops.bilinear
class_center_sample = _C_ops.class_center_sample
flashmask_attention = _C_ops.flashmask_attention
fold = _C_ops.fold
fractional_max_pool2d = _C_ops.fractional_max_pool2d
fractional_max_pool3d = _C_ops.fractional_max_pool3d
gather_tree = _C_ops.gather_tree
hsigmoid_loss = _C_ops.hsigmoid_loss
label_smooth = _C_ops.label_smooth
log_loss = _C_ops.log_loss
lp_pool2d = _C_ops.lp_pool2d
margin_cross_entropy = _C_ops.margin_cross_entropy
rrelu = _C_ops.rrelu
sequence_mask = _C_ops.sequence_mask
sparse_attention = _C_ops.sparse_attention
# the four adaptive pools take paddle's `name` argument, which the ops'
# manifest signatures do not have
def adaptive_avg_pool1d(x, output_size, name=None):
    return OPS["adaptive_avg_pool1d"](x, output_size)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return OPS["adaptive_avg_pool3d"](x, output_size, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return OPS["adaptive_max_pool1d"](x, output_size, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW", name=None):
    return OPS["adaptive_max_pool3d"](x, output_size, return_mask,
                                      data_format)


def _reduce(loss, reduction):
    if reduction == "mean":
        return OPS["mean"](loss)
    if reduction == "sum":
        return OPS["sum"](loss)
    return loss


# -- pooling / conv wrappers -------------------------------------------------

def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        out = OPS["max_pool3d_with_index"](x, kernel_size, stride, padding)
        return out
    return OPS["pool3d"](x, kernel_size, stride, padding,
                         pooling_type="max", ceil_mode=ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    out = OPS["pool3d"](x, kernel_size, stride, padding,
                        pooling_type="avg", ceil_mode=ceil_mode,
                        count_include_pad=not exclusive)
    if divisor_override is not None:
        k = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * 3
        out = out * (float(np.prod(k)) / float(divisor_override))
    return out


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    return OPS["unpool"](x, indices, kernel_size, stride, padding,
                         output_size, data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return OPS["unpool3d"](x, indices, kernel_size, stride, padding,
                           output_size, data_format)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    x4 = OPS["unsqueeze"](x, 2)
    idx4 = OPS["unsqueeze"](indices, 2)
    if output_size is not None:
        output_size = [1, list(output_size)[-1]]
    out = OPS["unpool"](x4, idx4, [1, kernel_size],
                        [1, stride or kernel_size], [0, padding],
                        output_size, "NCHW")
    return OPS["squeeze"](out, 2)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    x4 = OPS["unsqueeze"](x, 2)
    out = OPS["lp_pool2d"](x4, norm_type, [1, kernel_size],
                           [1, stride or kernel_size], [0, padding],
                           ceil_mode)
    return OPS["squeeze"](out, 2)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """x [N, C, L], weight [C, C_out/groups, K] ; via the 2-D transposed
    conv on a height-1 image."""
    x4 = OPS["unsqueeze"](x, 2)
    w4 = OPS["unsqueeze"](weight, 2)

    def two(v):
        return [1, v] if isinstance(v, int) else [1, list(v)[0]]

    out = OPS["conv2d_transpose"](
        x4, w4, bias, stride=two(stride),
        padding=[0, padding if isinstance(padding, int)
                 else list(padding)[0]],
        output_padding=two(output_padding) if output_padding else 0,
        dilation=two(dilation), groups=groups, data_format="NCHW")
    out = OPS["squeeze"](out, 2)
    if output_size is not None:
        out = out[:, :, :list(output_size)[-1]]
    return out


def zeropad2d(x, padding, data_format="NCHW", name=None):
    if isinstance(padding, int):
        padding = [padding] * 4
    return OPS["pad"](x, list(padding), mode="constant", value=0.0,
                      data_format=data_format)


# -- dropout variants --------------------------------------------------------

def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout (reference: functional/common.py
    alpha_dropout): keeps self-normalizing statistics by replacing dropped
    units with alpha' and applying an affine correction."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = OPS["cast"](
        OPS["bernoulli"](OPS["full_like"](x, keep)), x.dtype)
    return (x * mask + alpha_p * (1.0 - mask)) * a + b


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """alpha_dropout with a per-channel mask (channel axis 1)."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    mask_shape = shape[:2] + [1] * (len(shape) - 2)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    ones = OPS["full"](mask_shape, keep, x.dtype)
    mask = OPS["cast"](OPS["bernoulli"](ones), x.dtype)
    return (x * mask + alpha_p * (1.0 - mask)) * a + b


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Drops whole 3-D channels (reference functional/common.py); the
    channel axis follows data_format."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if data_format == "NDHWC":
        mask_shape = [shape[0], 1, 1, 1, shape[-1]]
    else:
        mask_shape = shape[:2] + [1, 1, 1]
    ones = OPS["full"](mask_shape, 1.0 - p, x.dtype)
    mask = OPS["cast"](OPS["bernoulli"](ones), x.dtype)
    return x * mask / (1.0 - p)


# -- losses ------------------------------------------------------------------

def dice_loss(input, label, epsilon=1e-05, name=None):
    """reference: functional/loss.py dice_loss: input [N, ..., C] probs,
    label [N, ..., 1] int."""
    label_oh = OPS["squeeze"](OPS["one_hot"](label, input.shape[-1]), -2)
    axes = list(range(1, len(input.shape)))
    inter = OPS["sum"](input * label_oh, axes)
    union = OPS["sum"](input, axes) + OPS["sum"](label_oh, axes)
    dice = (2.0 * inter + epsilon) / (union + epsilon)
    return OPS["mean"](1.0 - dice)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """reference: functional/loss.py npair_loss."""
    reg = l2_reg * (OPS["mean"](OPS["sum"](anchor * anchor, 1))
                    + OPS["mean"](OPS["sum"](positive * positive, 1))) * 0.25
    sim = OPS["matmul"](anchor, positive, transpose_y=True)
    lab = OPS["reshape"](labels, [-1, 1])
    tgt = OPS["cast"](OPS["equal"](lab, OPS["reshape"](labels, [1, -1])),
                      sim.dtype)
    tgt = tgt / OPS["sum"](tgt, -1, keepdim=True)
    from . import softmax_with_cross_entropy  # late: sibling module

    ce = softmax_with_cross_entropy(sim, tgt, soft_label=True)
    return OPS["mean"](ce) + reg


def pairwise_distance(x, y, p=2.0, epsilon=1e-06, keepdim=False, name=None):
    return OPS["dist_elementwise"](x, y, p, epsilon, keepdim) \
        if "dist_elementwise" in OPS else _pnorm_lastdim(x - y, p, epsilon,
                                                         keepdim)


def _pnorm_lastdim(d, p, eps, keepdim):
    a = OPS["abs"](d) + eps
    if p == float("inf"):
        return OPS["max"](a, -1, keepdim)
    return OPS["pow"](OPS["sum"](OPS["pow"](a, p), -1, keepdim=keepdim),
                      1.0 / p)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    from . import cosine_similarity

    cos = cosine_similarity(input1, input2, axis=1)
    pos = 1.0 - cos
    neg = OPS["clip"](cos - margin, 0.0, float("inf"))
    lab64 = OPS["cast"](label, "int64")
    is_pos = OPS["equal"](lab64, OPS["full_like"](lab64, 1))
    loss = OPS["where"](is_pos, pos, neg)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-06,
                      reduction="mean", name=None):
    var = OPS["clip"](variance, epsilon, float("inf"))
    loss = 0.5 * (OPS["log"](var) + (input - label) ** 2 / var)
    if full:
        loss = loss + 0.5 * float(np.log(2 * np.pi))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    lab = OPS["cast"](label, input.dtype)
    pos = input
    neg = OPS["clip"](margin - input, 0.0, float("inf"))
    loss = OPS["where"](OPS["equal"](lab, OPS["full_like"](lab, 1.0)),
                        pos, neg)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    lab = OPS["cast"](label, input.dtype)
    loss = -(lab * OPS["log_sigmoid"](input)
             + (1.0 - lab) * OPS["log_sigmoid"](-input))
    if weight is not None:
        loss = loss * weight
    loss = OPS["mean"](loss, -1)
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    C = input.shape[1]
    correct = OPS["take_along_axis"](input, OPS["reshape"](label, [-1, 1]),
                                     1)
    m = OPS["clip"](margin - correct + input, 0.0, float("inf"))
    if p != 1:
        m = OPS["pow"](m, float(p))
    oh = OPS["one_hot"](label, C)
    m = m * (1.0 - oh)
    if weight is not None:
        # per-sample weight w[y_i], broadcast over the class axis
        m = m * OPS["reshape"](OPS["gather"](weight, label), [-1, 1])
    loss = OPS["sum"](m, 1) / float(C)
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-08, reduction="mean", name=None):
    if log_input:
        loss = OPS["exp"](input) - label * input
    else:
        loss = input - label * OPS["log"](input + epsilon)
    if full:
        big = label > 1.0
        stirling = (label * OPS["log"](OPS["clip"](label, 1e-12,
                                                   float("inf")))
                    - label + 0.5 * OPS["log"](
                        OPS["clip"](2 * np.pi * label, 1e-12, float("inf"))))
        loss = loss + OPS["where"](big, stirling,
                                   OPS["zeros_like"](stirling))
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    lab = OPS["cast"](label, input.dtype)
    loss = OPS["log"](1.0 + OPS["exp"](-lab * input))
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    """reference: functional/loss.py sigmoid_focal_loss (RetinaNet)."""
    p = OPS["sigmoid"](logit)
    lab = OPS["cast"](label, logit.dtype)
    ce = -(lab * OPS["log_sigmoid"](logit)
           + (1.0 - lab) * OPS["log_sigmoid"](-logit))
    p_t = p * lab + (1.0 - p) * (1.0 - lab)
    a_t = alpha * lab + (1.0 - alpha) * (1.0 - lab)
    loss = a_t * OPS["pow"](1.0 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    dp = pairwise_distance(input, positive, p, epsilon)
    dn = pairwise_distance(input, negative, p, epsilon)
    if swap:
        dn2 = pairwise_distance(positive, negative, p, epsilon)
        dn = OPS["minimum"](dn, dn2)
    loss = OPS["clip"](dp - dn + margin, 0.0, float("inf"))
    return _reduce(loss, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (lambda a, b: pairwise_distance(a, b))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = OPS["minimum"](dn, dist(positive, negative))
    loss = OPS["clip"](dp - dn + margin, 0.0, float("inf"))
    return _reduce(loss, reduction)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    loss = OPS["warprnnt"](input, label, input_lengths, label_lengths,
                           blank, fastemit_lambda)
    return _reduce(loss, reduction)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (reference: functional/loss.py
    adaptive_log_softmax_with_loss; Grave et al. 2017): frequent classes in
    the head, rare classes in down-projected tail clusters appended to the
    head as cluster logits. Returns (per-sample negative outputs, scalar
    loss) like the reference."""
    def u(t):
        return t._data if isinstance(t, Tensor) else torch.as_tensor(t)

    x, y, hw = u(input), u(label).long(), u(head_weight)
    shortlist = cutoffs[0]
    n_clusters = len(cutoffs) - 1 if len(cutoffs) > 1 else 0

    head_logits = x @ hw
    if head_bias is not None:
        head_logits = head_logits + u(head_bias)
    head_log = torch.log_softmax(head_logits, dim=-1)
    # the shortlist part, gathered a sample at a time
    in_short = y < shortlist
    short_ll = torch.gather(head_log, 1,
                            torch.clamp(y, 0, shortlist - 1)[:, None])[:, 0]
    ll = torch.where(in_short, short_ll, 0.0)
    bounds = list(cutoffs)
    for ci in range(n_clusters):
        lo, hi = bounds[ci], bounds[ci + 1]
        w1, w2 = u(tail_weights[ci][0]), u(tail_weights[ci][1])
        tail_log = torch.log_softmax((x @ w1) @ w2, dim=-1)
        in_c = (y >= lo) & (y < hi)
        idx = torch.clamp(y - lo, 0, hi - lo - 1)
        c_ll = head_log[:, shortlist + ci] \
            + torch.gather(tail_log, 1, idx[:, None])[:, 0]
        ll = torch.where(in_c, c_ll, ll)
    return Tensor._wrap(ll), Tensor._wrap(-torch.mean(ll))


# -- packed flash-attention wrappers ----------------------------------------

def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         name=None):
    """qkv [B, S, 3, H, D] packed: unpacked and run through the
    registered `flash_attn` (A1, A2 under autograd), with its shape
    rules."""
    q = qkv[:, :, 0]
    k = qkv[:, :, 1]
    v = qkv[:, :, 2]
    return OPS["flash_attn"](q, k, v, dropout=dropout, causal=causal,
                             return_softmax=return_softmax)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, name=None):
    """qkv [total_tokens, 3, H, D] packed varlen: through
    `flash_attn_unpadded` (A1's segment-id mode when the two packings
    are the same)."""
    q = qkv[:, 0]
    k = qkv[:, 1]
    v = qkv[:, 2]
    return OPS["flash_attn_unpadded"](
        q, k, v, cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k, scale=scale,
        dropout=dropout, causal=causal, return_softmax=return_softmax)


# -- in-place activation spellings ------------------------------------------

def _inplace(fn):
    def wrapper(x, *args, **kwargs):
        return x._rebind(fn(x, *args, **kwargs))

    return wrapper


relu_ = _inplace(OPS["relu"])
tanh_ = _inplace(OPS["tanh"])
elu_ = _inplace(OPS["elu"])
hardtanh_ = _inplace(OPS["hardtanh"])
leaky_relu_ = _inplace(OPS["leaky_relu"])
softmax_ = _inplace(OPS["softmax"])
thresholded_relu_ = _inplace(OPS["thresholded_relu"])
