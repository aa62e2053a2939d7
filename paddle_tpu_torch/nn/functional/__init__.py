"""nn.functional — the functional NN API: port of
`paddle_tpu/nn/functional/__init__.py`.

Thin wrappers mapping paddle signatures onto the port's op registry,
as in the reference; the vision wrappers (`grid_sample`, `affine_grid`,
`ctc_loss`, `pixel_unshuffle`, `channel_shuffle`, `temporal_shift`,
`max_pool2d_with_index`, `conv3d_transpose`) call the kernel tail's
ops. The tail (`extra.py`: pooling and unpooling wrappers, dropout
variants, the loss compositions, the packed flash-attention wrappers)
is star-imported at the end. Left for ROADMAP item 7: the
context-parallel `ring_attention` names.
"""
from __future__ import annotations

from ... import _C_ops
from ... import tensor as _tensor_api  # noqa: F401  (registers the base ops)

# Re-export elementwise activations straight from the op registry ------------
relu = _C_ops.relu
relu6 = _C_ops.relu6
leaky_relu = _C_ops.leaky_relu
prelu = _C_ops.prelu
elu = _C_ops.elu
selu = _C_ops.selu
celu = _C_ops.celu
gelu = _C_ops.gelu
silu = _C_ops.silu
swish = _C_ops.swish
mish = _C_ops.mish
hardswish = _C_ops.hardswish
hardsigmoid = _C_ops.hardsigmoid
hardtanh = _C_ops.hardtanh
hardshrink = _C_ops.hardshrink
softshrink = _C_ops.softshrink
tanhshrink = _C_ops.tanhshrink
softplus = _C_ops.softplus
softsign = _C_ops.softsign
thresholded_relu = _C_ops.thresholded_relu
log_sigmoid = _C_ops.log_sigmoid
sigmoid = _C_ops.sigmoid
tanh = _C_ops.tanh
softmax = _C_ops.softmax
log_softmax = _C_ops.log_softmax
gumbel_softmax = _C_ops.gumbel_softmax
maxout = _C_ops.maxout
glu = _C_ops.glu
swiglu = _C_ops.swiglu

linear = _C_ops.linear
embedding_op = _C_ops.embedding
conv1d = _C_ops.conv1d
conv2d = _C_ops.conv2d
conv3d = _C_ops.conv3d
conv2d_transpose = _C_ops.conv2d_transpose
conv3d_transpose = _C_ops.conv3d_transpose
max_pool1d = _C_ops.max_pool1d
avg_pool1d = _C_ops.avg_pool1d
max_pool2d = _C_ops.max_pool2d
avg_pool2d = _C_ops.avg_pool2d
adaptive_avg_pool2d = _C_ops.adaptive_avg_pool2d
adaptive_max_pool2d = _C_ops.adaptive_max_pool2d
pad = _C_ops.pad
unfold = _C_ops.unfold
pixel_shuffle = _C_ops.pixel_shuffle
one_hot = _C_ops.one_hot
layer_norm = _C_ops.layer_norm
rms_norm = _C_ops.rms_norm
group_norm = _C_ops.group_norm
instance_norm = _C_ops.instance_norm
local_response_norm = _C_ops.local_response_norm
scaled_dot_product_attention = _C_ops.scaled_dot_product_attention


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return embedding_op(x, weight, padding_idx, sparse)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    if axis is not None:
        raise NotImplementedError("dropout axis is not supported yet")
    return _C_ops.dropout(x, p, training, mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return _C_ops.dropout(x, p, training, "upscale_in_train")


def batch_norm(
    x,
    running_mean,
    running_var,
    weight=None,
    bias=None,
    training=False,
    momentum=0.9,
    epsilon=1e-05,
    data_format="NCHW",
    use_global_stats=None,
    name=None,
):
    """Functional batch_norm. In training mode the caller (the BatchNorm layer)
    is responsible for updating running stats from the returned batch stats."""
    if training and not use_global_stats:
        out, _, _ = _C_ops.batch_norm_train(x, weight, bias, epsilon, data_format)
        return out
    return _C_ops.batch_norm_infer(x, running_mean, running_var, weight, bias, epsilon, data_format)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = _C_ops.p_norm(x, float(p), axis, True, epsilon)
    return _C_ops.divide(x, _C_ops.maximum(norm, _C_ops.full_like(norm, epsilon)))


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = _C_ops.sum(_C_ops.multiply(x1, x2), axis)
    n1 = _C_ops.sqrt(_C_ops.sum(_C_ops.multiply(x1, x1), axis))
    n2 = _C_ops.sqrt(_C_ops.sum(_C_ops.multiply(x2, x2), axis))
    denom = _C_ops.maximum(_C_ops.multiply(n1, n2), _C_ops.full_like(n1, eps * eps))
    return _C_ops.divide(dot, denom)


def interpolate(
    x, size=None, scale_factor=None, mode="nearest", align_corners=False, data_format="NCHW", name=None
):
    if size is None:
        h = x.shape[2] if data_format == "NCHW" else x.shape[1]
        w = x.shape[3] if data_format == "NCHW" else x.shape[2]
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor, scale_factor]
        size = [int(h * sf[0]), int(w * sf[1])]
    size = [int(s) for s in size]
    if mode == "nearest":
        return _C_ops.interpolate_nearest(x, size, data_format)
    if mode in ("bilinear", "linear"):
        return _C_ops.interpolate_bilinear(x, size, align_corners, data_format)
    raise NotImplementedError(f"interpolate mode {mode}")


upsample = interpolate


# ---- losses ----------------------------------------------------------------
def _reduce(loss, reduction):
    if reduction == "mean":
        return _C_ops.mean(loss)
    if reduction == "sum":
        return _C_ops.sum(loss)
    return loss


def cross_entropy(
    input,
    label,
    weight=None,
    ignore_index=-100,
    reduction="mean",
    soft_label=False,
    axis=-1,
    use_softmax=True,
    label_smoothing=0.0,
    name=None,
):
    """Reference: python/paddle/nn/functional/loss.py cross_entropy →
    softmax_with_cross_entropy kernel."""
    if label_smoothing > 0.0:
        n = input.shape[axis]
        if not soft_label:
            label = one_hot(label, n)
            soft_label = True
        smooth = _C_ops.scale(label, 1.0 - label_smoothing, label_smoothing / n)
        label = smooth
    if not use_softmax:
        logp = _C_ops.log(input)
        if soft_label:
            loss = _C_ops.scale(_C_ops.sum(_C_ops.multiply(label, logp), axis, None, True), -1.0)
        else:
            return nll_loss(_C_ops.log(input), label, weight, ignore_index, reduction)
    else:
        loss = _C_ops.softmax_with_cross_entropy(input, label, soft_label, ignore_index, axis)
    if weight is not None and not soft_label:
        w = _C_ops.reshape(_C_ops.gather(weight, _C_ops.reshape(label, [-1])), loss.shape)
        loss = _C_ops.multiply(loss, w)
        if reduction == "mean":
            return _C_ops.divide(_C_ops.sum(loss), _C_ops.sum(w))
    if reduction == "mean" and not soft_label and ignore_index >= 0:
        valid = _C_ops.cast(_C_ops.not_equal(label, _C_ops.full_like(label, ignore_index)), "float32")
        return _C_ops.divide(_C_ops.sum(loss), _C_ops.maximum(_C_ops.sum(valid), _C_ops.full([], 1.0)))
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    return _C_ops.nll_loss(input, label, weight, ignore_index, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(_C_ops.square(_C_ops.subtract(input, label)), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(_C_ops.abs(_C_ops.subtract(input, label)), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _reduce(_C_ops.huber_loss(input, label, delta), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    eps = 1e-12
    loss = _C_ops.scale(
        _C_ops.add(
            _C_ops.multiply(label, _C_ops.log(_C_ops.clip(input, eps, 1.0))),
            _C_ops.multiply(
                _C_ops.scale(label, -1.0, 1.0),
                _C_ops.log(_C_ops.clip(_C_ops.scale(input, -1.0, 1.0), eps, 1.0)),
            ),
        ),
        -1.0,
    )
    if weight is not None:
        loss = _C_ops.multiply(loss, weight)
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(
    logit, label, weight=None, reduction="mean", pos_weight=None, name=None
):
    loss = _C_ops.bce_with_logits(logit, label, weight, pos_weight)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    return _C_ops.kl_div(input, label, reduction, log_target)


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100, axis=-1, **kw):
    return _C_ops.softmax_with_cross_entropy(logits, label, soft_label, ignore_index, axis)


def square_error_cost(input, label):
    return _C_ops.square(_C_ops.subtract(input, label))


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    out = _C_ops.relu(
        _C_ops.add(
            _C_ops.multiply(_C_ops.scale(label, -1.0), _C_ops.subtract(input, other)),
            _C_ops.full([], margin),
        )
    )
    return _reduce(out, reduction)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _C_ops.flatten(x, start_axis, stop_axis)


# -- the vision wrappers over the kernel tail ---------------------------------


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _C_ops.grid_sample(x, grid, mode=mode, padding_mode=padding_mode,
                              align_corners=align_corners)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    return _C_ops.affine_grid(theta, tuple(int(v) for v in out_shape),
                              align_corners=align_corners)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss; "mean" divides each sample's loss by its label length."""
    nll = _C_ops.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=blank, norm_by_times=norm_by_times)
    if reduction == "mean":
        return (nll / label_lengths.astype("float32")).mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _C_ops.pixel_unshuffle(x, downscale_factor=downscale_factor,
                                  data_format=data_format)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return _C_ops.channel_shuffle(x, groups=groups, data_format=data_format)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    return _C_ops.temporal_shift(x, seg_num=seg_num, shift_ratio=shift_ratio,
                                 data_format=data_format)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          global_pooling=False, name=None):
    return _C_ops.max_pool2d_with_index(
        x, kernel_size, stride=stride, padding=padding,
        global_pooling=global_pooling)


from .extra import *  # noqa: F401,F403,E402  (the functional tail)
