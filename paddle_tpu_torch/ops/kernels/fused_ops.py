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

The rest of the reference file is plain compositions, as there:
`fused_dropout_add` (:222), `fused_scale_bias_add_relu` (:241), the norm
fusions (:256-303), the attention fusions (:337-389), the conv fusions
(:420-482), `max_pool2d_v2` (:495) and the `fusion_*` sequence ops
(:518-585).
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
           "fused_elemwise_add_activation", "fused_dropout_add",
           "fused_scale_bias_add_relu", "skip_layernorm",
           "fused_bias_residual_layernorm", "fused_fc_elementwise_layernorm",
           "fused_embedding_eltwise_layernorm", "add_group_norm_silu",
           "fused_dot_product_attention", "self_dp_attention",
           "multihead_matmul", "fused_token_prune", "fused_conv2d_add_act",
           "resnet_unit", "resnet_basic_block", "squeeze_excitation_block",
           "max_pool2d_v2", "fusion_repeated_fc_relu",
           "fusion_squared_mat_sub", "fusion_transpose_flatten_concat",
           "fusion_gru", "fusion_lstm"]


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


# ---------------------------------------------------------------------------
# dropout, scale-bias fusions
# ---------------------------------------------------------------------------


def _nn():
    """The base nn kernels (imported at first use: `nn_ops` imports the
    incubate functions, which import this module)."""
    from . import nn_ops

    return nn_ops


@register_op
def fused_dropout_add(x, y, p=0.5, is_test=False, mode="upscale_in_train",
                      seed=0, fix_seed=False):
    """dropout(x) + y. downscale_in_infer masks raw at train time and
    scales by (1 - p) at inference; upscale_in_train rescales the kept
    values at train time and is the identity at inference."""
    if is_test or p == 0.0:
        scale = (1.0 - p) if mode == "downscale_in_infer" else 1.0
        return x * scale + y
    from ...core import rng

    if fix_seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = rng.seed_or_next(0, x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x)) + y


@register_op
def fused_scale_bias_add_relu(x1, scale1, bias1, x2, scale2=None,
                              bias2=None, fuse_dual=False,
                              exhaustive_search=False):
    """relu(x1 * s1 + b1 + (x2 * s2 + b2 if fuse_dual else x2))."""
    a = x1 * scale1 + bias1
    b = x2 * scale2 + bias2 if fuse_dual else x2
    return F.relu(a + b)


# ---------------------------------------------------------------------------
# layer-norm fusions
# ---------------------------------------------------------------------------


def _ln(x, scale, bias, eps, begin_norm_axis=-1):
    return _nn().layer_norm._kernel(x, scale, bias, eps, begin_norm_axis)


@register_op
def skip_layernorm(x, y, scale, bias, epsilon=1e-5, begin_norm_axis=-1):
    """LN(x + y), BERT's residual and norm."""
    return _ln(x + y, scale, bias, epsilon, begin_norm_axis)


@register_op
def fused_bias_residual_layernorm(x, bias=None, residual=None,
                                  norm_weight=None, norm_bias=None,
                                  epsilon=1e-5, residual_alpha=1.0,
                                  begin_norm_axis=-1, quant_scale=-1.0):
    """(LN(x + bias + alpha * residual), the pre-norm sum)."""
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual_alpha * residual
    return _ln(h, norm_weight, norm_bias, epsilon, begin_norm_axis), h


@register_op
def fused_fc_elementwise_layernorm(x, w, y, bias0=None, scale=None,
                                   bias1=None, epsilon=1e-5,
                                   begin_norm_axis=-1, activation_type=""):
    """LN(act(x @ w + b0) + y)."""
    h = torch.matmul(x, w)
    if bias0 is not None:
        h = h + bias0
    return _ln(_act(activation_type)(h) + y, scale, bias1, epsilon,
               begin_norm_axis)


@register_op
def fused_embedding_eltwise_layernorm(ids, embs, bias=None, scale=None,
                                      epsilon=1e-5):
    """LN(sum_i emb_i[ids_i]), BERT's embedding stack."""
    total = None
    for i, e in zip(ids, embs):
        looked = e[i.long()]
        total = looked if total is None else total + looked
    return _ln(total, scale, bias, epsilon)


@register_op
def add_group_norm_silu(x, residual=None, scale=None, bias=None,
                        epsilon=1e-5, groups=1, data_format="NCHW",
                        activation="silu"):
    """silu(GN(x + residual))."""
    h = x + residual if residual is not None else x
    out = _nn().group_norm._kernel(h, scale, bias, epsilon, groups,
                                   data_format)
    if isinstance(out, tuple):
        out = out[0]
    return F.silu(out) if activation == "silu" else out


# ---------------------------------------------------------------------------
# attention fusions
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask=None, scale=None, dropout_p=0.0):
    """[B, H, T, D] attention, dropout on the probabilities."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhtd,bhsd->bhts", q, k) * s
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, -1)
    if dropout_p > 0.0:
        from ...core import rng

        gen = rng.next_generator(q.device)
        keep = torch.rand(probs.shape, generator=gen,
                          device=q.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.einsum("bhts,bhsd->bhtd", probs, v)


@register_op
def fused_dot_product_attention(q, k, v, mask=None, scaling_factor=None,
                                dropout_probability=0.0, is_training=False,
                                is_causal_masking=False):
    """[B, T, H, D] attention; causal adds the -1e9 upper-triangle mask."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    m = None
    if is_causal_masking:
        T, S = qt.shape[2], kt.shape[2]
        tril = torch.ones((T, S), dtype=torch.bool, device=q.device).tril()
        m = torch.where(tril, 0.0, -1e9).to(q.dtype)
    if mask is not None:
        m = mask if m is None else m + mask
    p = dropout_probability if is_training else 0.0
    return _sdpa(qt, kt, vt, m, scaling_factor, dropout_p=p).transpose(1, 2)


@register_op
def self_dp_attention(x, alpha=1.0, head_number=1):
    """Packed-QKV self-attention: x [B, T, 3, H, D] -> [B, T, H·D]."""
    out = fused_dot_product_attention._kernel(
        x[:, :, 0], x[:, :, 1], x[:, :, 2], None, alpha,
        is_causal_masking=False)
    return out.reshape(out.shape[0], out.shape[1], -1)


@register_op
def multihead_matmul(input, w, bias=None, bias_qk=None, transpose_qkv=False,
                     alpha=1.0, head_number=1):
    """One packed QKV projection, attention and the head merge: input
    [B, T, C], w [C, 3, H, D] (or [3, H, D, C] with transpose_qkv)."""
    B, T, C = input.shape
    if transpose_qkv:
        D = w.numel() // (3 * head_number * C)
        w = w.reshape(3, head_number, D, C).permute(3, 0, 1, 2)
    qkv = torch.einsum("btc,chnd->bthnd", input,
                       w.reshape(C, 3, head_number, -1))
    if bias is not None:
        qkv = qkv + bias.reshape(3, head_number, -1)[None, None]
    qt, kt, vt = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = _sdpa(qt, kt, vt, bias_qk, alpha)
    return out.transpose(1, 2).reshape(B, T, C)


@register_op
def fused_token_prune(attn, x, mask, new_mask, keep_first_token=True,
                      keep_order=False):
    """Keep the tokens with the largest column-summed attention; the
    output length is new_mask's third axis."""
    keep = new_mask.shape[2]
    score = (attn * (mask > 0)).sum(dim=(1, 2))           # [B, T]
    if keep_first_token:
        score = score.clone()
        score[:, 0] = float("inf")
    idx = torch.argsort(-score, dim=1, stable=True)[:, :keep]
    if keep_order:
        idx = torch.sort(idx, dim=1).values
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return out, idx.long()


# ---------------------------------------------------------------------------
# conv fusions
# ---------------------------------------------------------------------------


def _conv2d(x, w, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCHW"):
    return _nn()._conv_nd(x, w, None, stride, padding, dilation, groups,
                          data_format, 2)


@register_op
def fused_conv2d_add_act(input, filter, bias=None, residual_data=None,
                         strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
                         groups=1, activation="relu",
                         padding_algorithm="EXPLICIT", split_channels=()):
    """act(conv(x, w) + bias + residual)."""
    pad = paddings if padding_algorithm in ("EXPLICIT", "", None) \
        else padding_algorithm
    out = _conv2d(input, filter, strides, pad, dilations, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    if residual_data is not None:
        out = out + residual_data
    return _act(activation)(out)


def _bn_infer(x, scale, bias, mean, var, eps):
    inv = scale / torch.sqrt(var + eps)
    return x * inv.reshape(1, -1, 1, 1) + (
        bias - mean * inv).reshape(1, -1, 1, 1)


@register_op
def resnet_unit(x, filter_x, scale_x, bias_x, mean_x, var_x,
                z=None, filter_z=None, scale_z=None, bias_z=None,
                mean_z=None, var_z=None, stride=1, padding=1,
                dilation=1, group=1, momentum=0.9, epsilon=1e-5,
                fuse_add=False, has_shortcut=False, act_type="relu"):
    """conv + BN (+ a shortcut conv + BN, or a raw add) + act, with
    inference statistics."""
    out = _bn_infer(_conv2d(x, filter_x, stride, padding, dilation, group),
                    scale_x, bias_x, mean_x, var_x, epsilon)
    if has_shortcut and z is not None:
        out = out + _bn_infer(_conv2d(z, filter_z, stride, 0, 1, group),
                              scale_z, bias_z, mean_z, var_z, epsilon)
    elif fuse_add and z is not None:
        out = out + z
    return _act(act_type)(out)


@register_op
def resnet_basic_block(x, filter1, scale1, bias1, mean1, var1,
                       filter2, scale2, bias2, mean2, var2,
                       filter3=None, scale3=None, bias3=None, mean3=None,
                       var3=None, stride1=1, stride2=1, stride3=1,
                       padding1=1, padding2=1, padding3=0,
                       has_shortcut=False, epsilon=1e-5, act_type="relu"):
    """Two conv + BN stages (relu between) with an identity or projected
    shortcut, then act."""
    h = F.relu(_bn_infer(_conv2d(x, filter1, stride1, padding1),
                         scale1, bias1, mean1, var1, epsilon))
    h = _bn_infer(_conv2d(h, filter2, stride2, padding2),
                  scale2, bias2, mean2, var2, epsilon)
    sc = (_bn_infer(_conv2d(x, filter3, stride3, padding3),
                    scale3, bias3, mean3, var3, epsilon)
          if has_shortcut else x)
    return _act(act_type)(h + sc)


@register_op
def squeeze_excitation_block(x, filter_squeeze, filter_excitation,
                             act_type=("relu", "sigmoid")):
    """Global average pool, 1x1 reduce, act, 1x1 expand, gate."""
    pooled = x.mean(dim=(2, 3), keepdim=True)
    a1, a2 = act_type if isinstance(act_type, (tuple, list)) else (
        "relu", "sigmoid")
    g = _act(a2)(_conv2d(_act(a1)(_conv2d(pooled, filter_squeeze)),
                         filter_excitation))
    return x * g


@register_op
def max_pool2d_v2(x, kernel_size, stride=None, padding=0,
                  data_format="NCHW", global_pooling=False,
                  adaptive=False, ceil_mode=False):
    """Max pooling without the index output."""
    if adaptive:
        raise NotImplementedError(
            "max_pool2d_v2 adaptive=True: use adaptive_max_pool2d")
    if global_pooling:
        spatial = x.shape[1:3] if data_format == "NHWC" else x.shape[2:4]
        kernel_size, stride, padding = tuple(spatial), (1, 1), 0
    return _nn()._pool(x, kernel_size, stride, padding, data_format, "max",
                       2, ceil_mode)


# ---------------------------------------------------------------------------
# sequence fusions
# ---------------------------------------------------------------------------


@register_op
def fusion_repeated_fc_relu(x, w, bias):
    """relu(x @ w_i + b_i), chained."""
    out = x
    for wi, bi in zip(w, bias):
        out = F.relu(torch.matmul(out, wi) + bi)
    return out


@register_op
def fusion_squared_mat_sub(x, y, scalar=1.0):
    """scalar * ((x @ y)^2 - x^2 @ y^2)."""
    ab = torch.matmul(x, y)
    return scalar * (ab * ab - torch.matmul(x * x, y * y))


@register_op
def fusion_transpose_flatten_concat(x, trans_axis, flatten_axis,
                                    concat_axis):
    outs = []
    for t in x:
        tr = t.permute(*trans_axis)
        lead = math.prod(tr.shape[:flatten_axis])
        outs.append(tr.reshape(lead, -1))
    return torch.cat(outs, dim=concat_axis)


def _scan(step, carry, seq, reverse):
    """Run step over seq [T, ...] (backwards when reverse); the per-step
    outputs stacked in time order."""
    ts = range(seq.shape[0] - 1, -1, -1) if reverse else range(seq.shape[0])
    outs = [None] * seq.shape[0]
    for t in ts:
        carry, outs[t] = step(carry, seq[t])
    return carry, torch.stack(outs)


@register_op
def fusion_gru(x, weight_x, weight_h, h0=None, bias=None,
               activation="tanh", gate_activation="sigmoid",
               is_reverse=False, origin_mode=False):
    """The input projection and the GRU recurrence; x [B, T, I]."""
    B, T, _ = x.shape
    H = weight_h.shape[0]
    gx = torch.einsum("bti,ih->bth", x, weight_x)
    if bias is not None:
        gx = gx + bias
    act, gact = _act(activation), _act(gate_activation)
    h_init = h0 if h0 is not None else x.new_zeros(B, H)
    wu, wr, wc = weight_h[:, :H], weight_h[:, H:2 * H], weight_h[:, 2 * H:]

    def step(h, g):
        u = gact(g[:, :H] + h @ wu)
        r = gact(g[:, H:2 * H] + h @ wr)
        c = act(g[:, 2 * H:] + (r * h) @ wc)
        h2 = u * h + (1 - u) * c if origin_mode else (1 - u) * h + u * c
        return h2, h2

    hT, hs = _scan(step, h_init, gx.transpose(0, 1), is_reverse)
    return hs.transpose(0, 1), hT


@register_op
def fusion_lstm(x, weight_x, weight_h, h0=None, c0=None, bias=None,
                activation="tanh", gate_activation="sigmoid",
                cell_activation="tanh", is_reverse=False):
    """The input projection and the LSTM recurrence; x [B, T, I]."""
    B, T, _ = x.shape
    H = weight_h.shape[0]
    gx = torch.einsum("bti,ih->bth", x, weight_x)
    if bias is not None:
        gx = gx + bias
    gact, cact, hact = (_act(gate_activation), _act(cell_activation),
                        _act(activation))
    h_init = h0 if h0 is not None else x.new_zeros(B, H)
    c_init = c0 if c0 is not None else x.new_zeros(B, H)

    def step(carry, g):
        h, c = carry
        z = g + h @ weight_h
        c2 = gact(z[:, H:2 * H]) * c + gact(z[:, :H]) * cact(
            z[:, 2 * H:3 * H])
        h2 = gact(z[:, 3 * H:]) * hact(c2)
        return (h2, c2), h2

    (hT, cT), hs = _scan(step, (h_init, c_init), gx.transpose(0, 1),
                         is_reverse)
    return hs.transpose(0, 1), hT, cT
