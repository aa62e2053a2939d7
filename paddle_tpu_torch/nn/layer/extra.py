"""The tail of the nn layers: port of `paddle_tpu/nn/layer/extra.py`.

The Layer classes over the functional tail (`nn/functional/extra.py`):
1-D and 3-D pools, unpools, dropout variants, loss modules, padding,
upsampling; `ParameterDict`; and sequence decoding (`BeamSearchDecoder`,
`dynamic_decode`), stepped on the host as in the reference.
"""
from __future__ import annotations

import numpy as np

from ... import _C_ops
from .. import functional as F
from ..initializer import XavierNormal
from .layers import Layer

__all__ = [
    "AdaptiveAvgPool1D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool3D", "AdaptiveLogSoftmaxWithLoss", "AlphaDropout",
    "AvgPool3D", "MaxPool3D", "BeamSearchDecoder", "Bilinear",
    "ChannelShuffle", "Conv1DTranspose", "Conv3DTranspose",
    "CosineEmbeddingLoss", "Dropout3D", "FeatureAlphaDropout", "Fold",
    "FractionalMaxPool2D", "FractionalMaxPool3D", "GaussianNLLLoss",
    "HSigmoidLoss", "HingeEmbeddingLoss", "LPPool1D", "LPPool2D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "MultiLabelSoftMarginLoss", "MultiMarginLoss", "Pad1D", "Pad3D",
    "PairwiseDistance", "ParameterDict", "PixelShuffle", "PixelUnshuffle",
    "PoissonNLLLoss", "RNNTLoss", "RReLU", "SoftMarginLoss", "Softmax2D",
    "SpectralNorm", "TripletMarginLoss", "TripletMarginWithDistanceLoss",
    "Unflatten", "Unfold", "UpsamplingBilinear2D", "UpsamplingNearest2D",
    "ZeroPad1D", "ZeroPad3D", "dynamic_decode",
]


# -- pooling -----------------------------------------------------------------

class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, return_mask,
                     data_format)

    def forward(self, x):
        return F.max_pool3d(x, *self.args)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool3d(x, *self.args)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return F.lp_pool1d(x, *self.args)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.lp_pool2d(x, *self.args)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.random_u = random_u
        self.return_mask = return_mask

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       kernel_size=self.kernel_size,
                                       random_u=self.random_u,
                                       return_mask=self.return_mask)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.random_u = random_u
        self.return_mask = return_mask

    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       kernel_size=self.kernel_size,
                                       random_u=self.random_u,
                                       return_mask=self.return_mask)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size, data_format)

    def forward(self, x, indices):
        k, s, p, out, fmt = self.args
        return F.max_unpool1d(x, indices, k, s, p, out, fmt)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size, data_format)

    def forward(self, x, indices):
        k, s, p, out, fmt = self.args
        return F.max_unpool2d(x, indices, k, s, p, out, fmt)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size, data_format)

    def forward(self, x, indices):
        k, s, p, out, fmt = self.args
        return F.max_unpool3d(x, indices, k, s, p, out, fmt)


# -- conv --------------------------------------------------------------------

class Conv1DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__()
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        init = XavierNormal()
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, k],
            default_initializer=init)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], default_initializer=None, is_bias=True)
        self._args = (stride, padding, output_padding, groups, dilation,
                      data_format)

    def forward(self, x, output_size=None):
        s, p, op, g, d, fmt = self._args
        return F.conv1d_transpose(x, self.weight, self.bias, s, p, op, g, d,
                                  output_size, fmt)


class Conv3DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__()
        k = ([kernel_size] * 3 if isinstance(kernel_size, int)
             else list(kernel_size))
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *k],
            default_initializer=XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], default_initializer=None, is_bias=True)
        self._args = (stride, padding, output_padding, groups, dilation,
                      data_format)

    def forward(self, x, output_size=None):
        s, p, op, g, d, fmt = self._args
        return _C_ops.conv3d_transpose(x, self.weight, self.bias, strides=s,
                                       paddings=p, output_padding=op,
                                       output_size=output_size, groups=g,
                                       dilations=d, data_format=fmt)


# -- simple wrappers ---------------------------------------------------------

class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features],
            default_initializer=XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [1, out_features], default_initializer=None, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        from ... import unflatten

        return unflatten(x, self.axis, self.shape)


class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW inputs."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper,
                       is_test=not self.training)


class SpectralNorm(Layer):
    """Standalone spectral-norm layer (reference: nn/layer/norm.py
    SpectralNorm): returns the weight normalized by its largest singular
    value via power iteration; u/v are persistent power-iteration state."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        from ... import randn

        self.register_buffer("weight_u", randn([h], dtype))
        self.register_buffer("weight_v", randn([w], dtype))

    def forward(self, weight):
        return _C_ops.spectral_norm(weight, self.weight_u, self.weight_v,
                                    self.dim, self.power_iters, self.epsilon)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, self.training)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


# -- padding -----------------------------------------------------------------

class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding = ([padding] * 2 if isinstance(padding, int)
                        else list(padding))
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return _C_ops.pad(x, self.padding, self.mode, self.value,
                          self.data_format)


class Pad3D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.padding = ([padding] * 6 if isinstance(padding, int)
                        else list(padding))
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return _C_ops.pad3d(x, self.padding, self.mode, self.value,
                            self.data_format)


class ZeroPad1D(Pad1D):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad3D(Pad3D):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


# -- upsampling --------------------------------------------------------------

class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "nearest",
                             data_format=self.data_format)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             align_corners=True,
                             data_format=self.data_format)


# -- distance / losses -------------------------------------------------------

class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-06, keepdim=False, name=None):
        super().__init__()
        self.args = (p, epsilon, keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, *self.args)


def _loss_layer(name, fn, arg_names, defaults):
    """Build a Layer class delegating to a functional loss ; the reference's
    loss modules are exactly this shape."""

    class _Loss(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            bad = set(kwargs) - set(arg_names) - {"name"}
            if bad:
                raise TypeError(f"{name}: unexpected args {sorted(bad)}")
            kwargs.pop("name", None)
            self.kwargs = {**defaults, **kwargs}

        def forward(self, *inputs):
            return fn(*inputs, **self.kwargs)

    _Loss.__name__ = name
    _Loss.__qualname__ = name
    return _Loss


CosineEmbeddingLoss = _loss_layer(
    "CosineEmbeddingLoss", F.cosine_embedding_loss,
    ["margin", "reduction"], {"margin": 0.0, "reduction": "mean"})
GaussianNLLLoss = _loss_layer(
    "GaussianNLLLoss", F.gaussian_nll_loss,
    ["full", "epsilon", "reduction"],
    {"full": False, "epsilon": 1e-06, "reduction": "mean"})
HingeEmbeddingLoss = _loss_layer(
    "HingeEmbeddingLoss", F.hinge_embedding_loss,
    ["margin", "reduction"], {"margin": 1.0, "reduction": "mean"})
MultiLabelSoftMarginLoss = _loss_layer(
    "MultiLabelSoftMarginLoss", F.multi_label_soft_margin_loss,
    ["weight", "reduction"], {"weight": None, "reduction": "mean"})
MultiMarginLoss = _loss_layer(
    "MultiMarginLoss", F.multi_margin_loss,
    ["p", "margin", "weight", "reduction"],
    {"p": 1, "margin": 1.0, "weight": None, "reduction": "mean"})
PoissonNLLLoss = _loss_layer(
    "PoissonNLLLoss", F.poisson_nll_loss,
    ["log_input", "full", "epsilon", "reduction"],
    {"log_input": True, "full": False, "epsilon": 1e-08,
     "reduction": "mean"})
SoftMarginLoss = _loss_layer(
    "SoftMarginLoss", F.soft_margin_loss, ["reduction"],
    {"reduction": "mean"})
TripletMarginLoss = _loss_layer(
    "TripletMarginLoss", F.triplet_margin_loss,
    ["margin", "p", "epsilon", "swap", "reduction"],
    {"margin": 1.0, "p": 2.0, "epsilon": 1e-06, "swap": False,
     "reduction": "mean"})
TripletMarginWithDistanceLoss = _loss_layer(
    "TripletMarginWithDistanceLoss", F.triplet_margin_with_distance_loss,
    ["distance_function", "margin", "swap", "reduction"],
    {"distance_function": None, "margin": 1.0, "swap": False,
     "reduction": "mean"})
RNNTLoss = _loss_layer(
    "RNNTLoss", F.rnnt_loss,
    ["blank", "fastemit_lambda", "reduction"],
    {"blank": 0, "fastemit_lambda": 0.001, "reduction": "mean"})


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size],
            default_initializer=XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], default_initializer=None, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax module (reference: nn/layer/loss.py
    AdaptiveLogSoftmaxWithLoss): head covers the shortlist + one logit per
    tail cluster; each tail cluster is a down-projected two-matrix
    factorization."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if any(c <= 0 or c >= n_classes for c in cutoffs) or \
                sorted(set(cutoffs)) != cutoffs:
            raise ValueError("cutoffs must be unique, increasing, and in "
                             "(0, n_classes)")
        self.cutoffs = cutoffs + [n_classes]
        self.shortlist = cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        head_out = self.shortlist + self.n_clusters
        self.head_weight = self.create_parameter(
            [in_features, head_out], default_initializer=XavierNormal())
        self.head_bias = self.create_parameter(
            [head_out], default_initializer=None, is_bias=True) \
            if head_bias else None
        self.tail_weights = []
        for ci in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (ci + 1))))
            osz = self.cutoffs[ci + 1] - self.cutoffs[ci]
            w1 = self.create_parameter([in_features, hsz],
                                       default_initializer=XavierNormal())
            w2 = self.create_parameter([hsz, osz],
                                       default_initializer=XavierNormal())
            self.add_parameter(f"tail_{ci}_w1", w1)
            self.add_parameter(f"tail_{ci}_w2", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            [self.shortlist] + self.cutoffs[1:], self.head_bias)


# -- containers --------------------------------------------------------------

class ParameterDict(Layer):
    """Dict-style parameter container (reference: nn/layer/container.py)."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            for k, v in (parameters.items()
                         if isinstance(parameters, dict) else parameters):
                self.add_parameter(str(k), v)

    def __getitem__(self, key):
        return self._parameters[str(key)]

    def __setitem__(self, key, value):
        self.add_parameter(str(key), value)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def keys(self):
        return self._parameters.keys()

    def values(self):
        return self._parameters.values()

    def items(self):
        return self._parameters.items()

    def update(self, parameters):
        for k, v in (parameters.items()
                     if isinstance(parameters, dict) else parameters):
            self.add_parameter(str(k), v)


# -- sequence decoding -------------------------------------------------------

class BeamSearchDecoder:
    """Beam-search decoder over an RNN cell (reference:
    nn/decode.py BeamSearchDecoder). Host-driven: `dynamic_decode` steps the
    cell, expands beams with the `beam_search` op semantics (top-k over
    accumulated log-probs), and backtracks with `gather_tree`."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """The greedy-per-beam decode loop (paddle's nn/decode.py
    dynamic_decode). Returns (ids [B, T_out, beam], final_state)."""
    import torch

    from ...core.tensor import Tensor

    cell = decoder.cell
    beam = decoder.beam_size
    state = inits
    # the batch, from the initial state
    leaves = [s for s in (state if isinstance(state, (list, tuple))
                          else [state]) if s is not None]
    B = int(leaves[0].shape[0]) if leaves else 1
    dev = leaves[0]._data.device if leaves and isinstance(leaves[0], Tensor) \
        else None

    def tile(s):
        if s is None:
            return None
        arr = s._data if isinstance(s, Tensor) else torch.as_tensor(s)
        return Tensor._wrap(arr.repeat_interleave(beam, dim=0))

    state = [tile(s) for s in state] if isinstance(state, (list, tuple)) \
        else tile(state)
    tok = torch.full((B * beam,), decoder.start_token, dtype=torch.int64,
                     device=dev)
    log_probs = torch.zeros((B * beam,), dtype=torch.float32, device=dev)
    finished = torch.zeros((B * beam,), dtype=torch.bool, device=dev)
    ids = []
    for _ in range(max_step_num):
        t = Tensor._wrap(tok)
        inp = decoder.embedding_fn(t) if decoder.embedding_fn else t
        out, state = cell(inp, state)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        lp = torch.log_softmax(logits._data if isinstance(logits, Tensor)
                               else torch.as_tensor(logits), dim=-1)
        nxt = torch.argmax(lp, dim=-1)
        step_lp = torch.amax(lp, dim=-1)
        log_probs = log_probs + torch.where(finished, 0.0, step_lp)
        nxt = torch.where(finished, decoder.end_token, nxt)
        finished = finished | (nxt == decoder.end_token)
        ids.append(nxt)
        tok = nxt.to(torch.int64)
        if bool(finished.all()):
            break
    seq = torch.stack(ids, dim=0).reshape(len(ids), B, beam)
    return Tensor._wrap(seq.permute(1, 0, 2).contiguous()), state
