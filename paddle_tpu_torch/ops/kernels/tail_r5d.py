"""Op tail 10 — port of `paddle_tpu/ops/kernels/tail_r5d.py`.

Debug checks, serving helpers, IR plumbing, the fused NN blocks (BN and
activation, conv-BN prologues and their backward, the fp8 gemm), DGC,
the sequence fusions (LoD offsets explicit), `attention_lstm`,
`fused_embedding_fc_lstm`, `cudnn_lstm` (over the `rnn` op), the v1
interpolation and proposal ops, `pyramid_hash` (host), and the YOLO
head ops `yolo_box_head` and `yolo_box_post` (decode by `yolo_box`, then
every class's NMS at once by `vision_ops._greedy_nms` on the device).

`comm_init_all`, `dist_concat`, `fetch_barrier` and `partial_allgather`
run through `distributed.collective`. Waiting: `sparse_coo_tensor`,
`indices` and `values` for ROADMAP item 9 (sparse).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core import flags, rng
from ..dispatch import OPS, register_op
from ._util import td, waiting

# ---------------------------------------------------------------------------
# debug / check
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def accuracy_check(x, y, fn_name="", rtol=1e-5, atol=1e-8, equal_nan=False):
    """Elementwise |x - y| <= atol + rtol * |y| (nan == nan with
    equal_nan)."""
    ok = (x - y).abs() <= atol + rtol * y.abs()
    if equal_nan:
        ok = ok | (torch.isnan(x) & torch.isnan(y))
    return ok


@register_op(nondiff=True)
def enable_check_model_nan_inf(x, flag=1):
    flags.set_flags({"FLAGS_check_nan_inf": bool(flag)})
    return x.clone()


@register_op(nondiff=True)
def disable_check_model_nan_inf(x, flag=0):
    flags.set_flags({"FLAGS_check_nan_inf": bool(flag)})
    return x.clone()


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    return seq_lens_encoder.max().reshape(1), seq_lens_decoder.max().reshape(1)


@register_op(nondiff=True)
def calc_reduced_attn_scores(q, k, softmax_lse):
    """reduced[b,h,j] = sum_i exp(q_i . k_j * scale - lse[b,h,i]);
    q/k [B, S, H, D], lse [B, H, Sq] -> [B, H, 1, Sk]."""
    s = torch.einsum("bihd,bjhd->bhij", q.to(torch.float32),
                     k.to(torch.float32)) / np.sqrt(q.shape[-1])
    p = torch.exp(s - softmax_lse.to(torch.float32)[..., None])
    return p.sum(2)[:, :, None, :]


@register_op
def qkv_unpack_mha(q, k, v, src_mask):
    """Masked attention on q/k/v [B, S, H, D] with an additive mask."""
    s = torch.einsum("bihd,bjhd->bhij", q, k) / np.sqrt(q.shape[-1])
    if src_mask is not None:
        s = s + src_mask.to(s.dtype)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhij,bjhd->bihd", p, v)


# ---------------------------------------------------------------------------
# IR plumbing
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def data(name="", shape=(), dtype="float32", place=None):
    """A feed placeholder: zeros of the declared shape (-1 as 1)."""
    from ._util import device

    shape = tuple(max(int(s), 0) if int(s) != -1 else 1 for s in shape)
    return torch.zeros(shape, dtype=td(dtype), device=device())


@register_op(nondiff=True)
def shadow_output(x, name=""):
    return x.clone()


@register_op(nondiff=True)
def share_buffer(x, share_dims_and_dtype=()):
    """The inputs unchanged and a found flag each."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    return xs, [torch.ones((), dtype=torch.bool, device=v.device)
                for v in xs]


sparse_coo_tensor = waiting("sparse_coo_tensor", 9)
indices = waiting("indices", 9)
values = waiting("values", 9)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def comm_init_all(devices=(), ring_id=0):
    """Communicator init (legacy/static_ops.yaml:86): forms `ring_id`'s
    group if it is the default and there is none (on the current place),
    raises if there is no such group; returns 0."""
    from .tail_collective import ring_group
    from ._util import device
    dev = device()
    ring_group(ring_id, dev.type)
    return torch.zeros((), dtype=torch.int32, device=dev)


@register_op(nondiff=True)
def dist_concat(x, ring_id=0, nranks=1):
    """Every rank's x concatenated on the last dim (legacy/static_ops.yaml
    :176)."""
    return OPS["c_concat"]._kernel(x, ring_id=ring_id)


@register_op(nondiff=True)
def fetch_barrier(x, trainer_id=0, endpoints=("127.0.0.1:6164",)):
    """PS-mode fetch barrier (legacy/static_ops.yaml:268): every rank of
    the default group arrives, then the fetches pass through (copies)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    OPS["barrier"]._kernel(xs[0] if xs else None, ring_id=0)
    return [v.clone() for v in xs]


@register_op(nondiff=True)
def partial_allgather(x, nranks=1, rank=0, ring_id=0):
    """Each rank contributes rows [rank·N/nranks, (rank+1)·N/nranks) of
    x; the all_gather restores the whole tensor on every rank
    (ops.yaml:3722)."""
    per = x.shape[0] // max(int(nranks), 1)
    mine = x[int(rank) * per:(int(rank) + 1) * per]
    return OPS["all_gather"]._kernel(mine.contiguous(), ring_id=ring_id)


# ---------------------------------------------------------------------------
# fused NN
# ---------------------------------------------------------------------------


def _bn_train(x, scale, bias, mean, variance, momentum, epsilon):
    """Training-mode BN over channel-last x: (y, new_mean, new_var,
    saved_mean, saved_inv_std)."""
    axes = tuple(range(x.ndim - 1))
    mu = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    inv = torch.rsqrt(var + epsilon)
    y = (x - mu) * inv * scale + bias
    return (y, momentum * mean + (1 - momentum) * mu,
            momentum * variance + (1 - momentum) * var, mu, inv)


_ACTS = {"relu": torch.relu, "identity": lambda v: v, "": lambda v: v,
         "sigmoid": torch.sigmoid, "tanh": torch.tanh}


@register_op
def fused_batch_norm_act(x, scale, bias, mean, variance, momentum=0.9,
                         epsilon=1e-5, act_type="relu"):
    """BN (batch statistics, NHWC) and an activation: (out, mean_out,
    variance_out, saved_mean, saved_variance)."""
    y, m, v, sm, sinv = _bn_train(x, scale, bias, mean, variance, momentum,
                                  epsilon)
    return _ACTS[act_type](y), m, v, sm, sinv


@register_op
def fused_bn_add_activation(x, z, scale, bias, mean, variance, momentum=0.9,
                            epsilon=1e-5, act_type="relu"):
    """act(BN(x) + z), the residual shortcut fusion."""
    y, m, v, sm, sinv = _bn_train(x, scale, bias, mean, variance, momentum,
                                  epsilon)
    return _ACTS[act_type](y + z), m, v, sm, sinv


_BINARY = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
           "elementwise_mul": torch.mul}


def _unary_fn(name, scale):
    if name == "scale":
        return lambda v: v * scale
    return _ACTS[name]


@register_op
def fused_elemwise_activation(x, y, functor_list=("elementwise_add", "relu"),
                              axis=-1, scale=0.0, save_intermediate_out=False):
    """functor_list[0] is the outer function: [unary, binary] gives
    unary(binary(x, y)); [binary, unary] gives binary(x, unary(y)). ->
    (out, intermediate)."""
    outer, inner = functor_list
    if outer in _BINARY:
        inter = _unary_fn(inner, scale)(y)
        return _BINARY[outer](x, inter), inter
    inter = _BINARY[inner](x, y)
    return _unary_fn(outer, scale)(inter), inter


@register_op
def conv2d_transpose_bias(x, filter, bias, strides=(1, 1), paddings=(0, 0),
                          output_padding=(), output_size=(),
                          padding_algorithm="EXPLICIT", groups=1,
                          dilations=(1, 1), data_format="NCHW"):
    """conv2d_transpose and a bias; output_size, when given, sets the
    output padding."""
    if padding_algorithm == "VALID":
        paddings = (0, 0)
    elif padding_algorithm == "SAME":
        raise NotImplementedError(
            "conv2d_transpose_bias with padding_algorithm='SAME' — pass "
            "explicit paddings (the SAME transpose split is caller-defined)")
    strides, paddings, dilations = (tuple(strides), tuple(paddings),
                                    tuple(dilations))
    if output_size:
        spatial = x.shape[2:4] if data_format == "NCHW" else x.shape[1:3]
        khw = filter.shape[2:4]
        output_padding = tuple(
            int(output_size[i]) - ((spatial[i] - 1) * strides[i]
                                   - 2 * paddings[i]
                                   + dilations[i] * (khw[i] - 1) + 1)
            for i in range(2))
        if any(p < 0 or p >= strides[i] for i, p in enumerate(output_padding)):
            raise ValueError(f"output_size {tuple(output_size)} unreachable "
                             f"for stride {strides}")
    return OPS["conv2d_transpose"]._kernel(
        x, filter, bias, stride=strides, padding=paddings,
        output_padding=tuple(output_padding) or 0, dilation=dilations,
        groups=groups, data_format=data_format)


@register_op
def conv3d_implicit_gemm(x, filter, strides=(1, 1, 1), paddings=(0, 0, 0),
                         padding_algorithm="EXPLICIT", groups=1,
                         dilations=(1, 1, 1), data_format="NCDHW"):
    """conv3d (implicit GEMM is an implementation, not a semantic)."""
    return OPS["conv3d"]._kernel(x, filter, stride=tuple(strides),
                                 padding=tuple(paddings), groups=groups,
                                 dilation=tuple(dilations),
                                 data_format=data_format)


@register_op
def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", activation_type="identity"):
    """Operands rounded through float8_e4m3fn, the product in f32, scaled,
    bias and activation, cast to float16 / bfloat16."""
    f8 = torch.float8_e4m3fn
    xq = x.to(f8).to(torch.float32)
    yq = y.to(f8).to(torch.float32)
    if transpose_x:
        xq = xq.transpose(-1, -2)
    if transpose_y:
        yq = yq.transpose(-1, -2)
    out = (xq @ yq) * scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    out = F.gelu(out, approximate="tanh") if activation_type == "gelu" \
        else _ACTS[activation_type](out)
    return out.to({"bfloat16": torch.bfloat16}.get(str(output_dtype),
                                                   torch.float16))


def _conv_nhwc(inp, w, strides, paddings, dilations, groups):
    """conv2d of NHWC input with an OIHW weight, NHWC out."""
    out = F.conv2d(inp.permute(0, 3, 1, 2), w, None, tuple(strides),
                   tuple(int(p) for p in paddings), tuple(dilations), groups)
    return out.permute(0, 2, 3, 1)


@register_op
def fused_scale_bias_relu_conv_bn(x, w, scale, bias, bn_scale, bn_bias,
                                  input_running_mean, input_running_var,
                                  paddings=(0, 0), dilations=(1, 1),
                                  strides=(1, 1),
                                  padding_algorithm="EXPLICIT", groups=1,
                                  data_format="NHWC", momentum=0.9,
                                  epsilon=1e-5, fuse_prologue=True,
                                  exhaustive_search=False,
                                  accumulation_count=0):
    """relu(x * scale + bias) -> conv -> BN statistics (x NHWC, weight
    OIHW). -> (conv out, running mean, running var, saved mean, saved
    inv std, eq_scale, eq_bias) with the BN affine folded for the next
    op."""
    h = torch.relu(x * scale + bias) if fuse_prologue else x
    conv = OPS["conv2d"]._kernel(h, w, stride=tuple(strides),
                                 padding=tuple(paddings), groups=groups,
                                 dilation=tuple(dilations),
                                 data_format="NHWC")
    mu = conv.mean(dim=(0, 1, 2))
    var = conv.var(dim=(0, 1, 2), unbiased=False)
    inv = torch.rsqrt(var + epsilon)
    return (conv, momentum * input_running_mean + (1 - momentum) * mu,
            momentum * input_running_var + (1 - momentum) * var, mu, inv,
            bn_scale * inv, bn_bias - bn_scale * mu * inv)


@register_op(nondiff=True)
def fused_dconv_drelu_dbn(grad_output, weight, grad_output_add,
                          residual_input, bn1_eqscale, bn1_eqbias,
                          conv_input, bn1_mean, bn1_inv_std, bn1_gamma,
                          bn1_beta, bn1_input, bn2_mean=None,
                          bn2_inv_std=None, bn2_gamma=None, bn2_beta=None,
                          bn2_input=None, paddings=(0, 0), dilations=(1, 1),
                          strides=(1, 1), padding_algorithm="EXPLICIT",
                          groups=1, data_format="NHWC", fuse_shortcut=False,
                          fuse_dual=False, fuse_add=False,
                          exhaustive_search=False):
    """The block's backward: dgrad of conv(relu(bn1(x))) through the conv
    (autograd of the forward), drelu by the recomputed relu input, then
    the BN1 gradients. -> (grad_weight, grad_bn1_input, grad_bn1_gamma,
    grad_bn1_beta); the dual-branch variants raise."""
    if fuse_shortcut or fuse_dual:
        raise NotImplementedError(
            "fused_dconv_drelu_dbn: fuse_shortcut/fuse_dual (the dual-BN-"
            "branch variants) are not implemented — this op computes the "
            "single-branch BN1 gradient set; compose the second branch "
            "from batch_norm grads explicitly")
    go = grad_output if not fuse_add else grad_output + grad_output_add
    relu_in = conv_input * bn1_eqscale + bn1_eqbias
    with torch.enable_grad():
        act = torch.relu(relu_in).to(torch.float32).detach().requires_grad_()
        w32 = weight.to(torch.float32).detach().requires_grad_()
        out = _conv_nhwc(act, w32, strides, paddings, dilations, groups)
        gin, gw = torch.autograd.grad(out, (act, w32),
                                      go.to(torch.float32))
    dact = torch.where(relu_in > 0, gin, torch.zeros_like(gin))
    xhat = (bn1_input - bn1_mean) * bn1_inv_std
    n = float(np.prod(bn1_input.shape[:-1]))
    dgamma = (dact * xhat).sum((0, 1, 2))
    dbeta = dact.sum((0, 1, 2))
    dxhat = dact * bn1_gamma
    dx = (bn1_inv_std / n) * (n * dxhat - dxhat.sum((0, 1, 2))
                              - xhat * (dxhat * xhat).sum((0, 1, 2)))
    return (gw.to(weight.dtype), dx.to(bn1_input.dtype),
            dgamma.to(bn1_gamma.dtype), dbeta.to(bn1_beta.dtype))


# ---------------------------------------------------------------------------
# DGC (deep gradient compression)
# ---------------------------------------------------------------------------


def _scalar(t):
    return float(np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                            else t).reshape(-1)[0])


def _dgc_sparsity(sparsity, step, rampup_steps):
    sp = list(sparsity) or [0.999]
    idx = int(step * len(sp) / max(rampup_steps, 1e-6))
    return sp[min(idx, len(sp) - 1)]


@register_op(nondiff=True)
def dgc(u, v, grad, param, current_step, nranks, m=0.9, use_nesterov=True,
        sparsity=(), rampup_begin_step=0.0, rampup_step=0.0,
        regular_coeff=0.0, regular_type=0):
    """One DGC step: grad' = nranks * grad (+ regularization), the u / v
    momentum update, the top-k of |v| encoded as [int32 indices bit-cast
    into f32; values], u and v zeroed there. -> (u_out, v_out,
    encode_grad [2k], grad_out, k [1])."""
    g = _scalar(nranks) * grad
    step = _scalar(current_step)
    if regular_type == 1:
        g = g + regular_coeff * torch.sign(param)
    elif regular_type == 2:
        g = g + regular_coeff * param
    dev = grad.device
    if step < rampup_begin_step:
        return (u, v, torch.zeros(0, device=dev), g,
                torch.zeros(1, dtype=torch.int32, device=dev))
    ratio = 1.0 - _dgc_sparsity(sparsity, step - rampup_begin_step,
                                rampup_step)
    k = max(int(grad.numel() * ratio), 1)
    if use_nesterov:
        u_new = m * (u + g)
        v_new = u + v + g
    else:
        u_new = m * u + g
        v_new = u_new + v
    flat = v_new.reshape(-1)
    idx = torch.topk(flat.abs(), k).indices
    encode = torch.cat([idx.to(torch.int32).view(torch.float32),
                        flat[idx].to(torch.float32)])
    keep = torch.ones_like(flat)
    keep[idx] = 0.0
    return ((u_new.reshape(-1) * keep).reshape(u.shape),
            (flat * keep).reshape(v.shape), encode, g,
            torch.full((1,), k, dtype=torch.int32, device=dev))


@register_op(nondiff=True)
def dgc_clip_by_norm(x, current_step, max_norm=1.0, rampup_begin_step=-1.0):
    """clip_by_norm from the DGC rampup step on."""
    if _scalar(current_step) < rampup_begin_step:
        return x.clone()
    norm = torch.sqrt((x.to(torch.float32) ** 2).sum())
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones((), device=x.device))
    return x * scale.to(x.dtype)


@register_op(nondiff=True)
def dgc_momentum(param, grad, velocity, learning_rate, master_param,
                 current_step_tensor, nranks_tensor, mu=0.9,
                 use_nesterov=False, regularization_method="",
                 regularization_coeff=0.0, multi_precision=False,
                 rescale_grad=1.0, rampup_begin_step=-1.0):
    """Momentum, plain SGD before the DGC rampup step. -> (param_out,
    velocity_out, master_param_out, grad_out)."""
    step = _scalar(current_step_tensor)
    g = grad * (rescale_grad / (_scalar(nranks_tensor) or 1.0))
    if regularization_method == "l2_decay":
        g = g + regularization_coeff * param
    if step < rampup_begin_step:
        return param - learning_rate * g, velocity, master_param, g
    v_new = mu * velocity + g
    p = param - learning_rate * (g + mu * v_new if use_nesterov else v_new)
    return p, v_new, master_param, g


# ---------------------------------------------------------------------------
# sequence fusions (explicit lod offsets)
# ---------------------------------------------------------------------------


def _offsets(lod):
    return np.asarray(lod.detach().cpu() if isinstance(lod, torch.Tensor)
                      else lod, np.int64).reshape(-1)


def _seq_pool_flat(x, lod, pooltype, pad_value=0.0):
    """Pool flat [N, D] rows a [lod[i], lod[i+1]) segment -> [B, D]."""
    off = _offsets(lod)
    pt = pooltype.upper()
    outs = []
    for i in range(len(off) - 1):
        seg = x[int(off[i]):int(off[i + 1])]
        if seg.shape[0] == 0:
            outs.append(torch.full((x.shape[1],), pad_value, dtype=x.dtype,
                                   device=x.device))
        elif pt == "SUM":
            outs.append(seg.sum(0))
        elif pt in ("AVERAGE", "AVG", "MEAN"):
            outs.append(seg.mean(0))
        elif pt == "MAX":
            outs.append(seg.amax(0))
        else:
            raise ValueError(f"unsupported pooltype {pooltype!r}")
    return torch.stack(outs)


@register_op(nondiff=True)
def fused_seqpool_cvm(x, cvm, lod, pooltype="SUM", pad_value=0.0,
                      use_cvm=True, cvm_offset=2):
    """Pool each slot's sequences; without use_cvm drop the leading
    show / click columns."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = []
    for xi in xs:
        p = _seq_pool_flat(xi, lod, pooltype, pad_value)
        outs.append(p if use_cvm else p[:, cvm_offset:])
    return outs


@register_op(nondiff=True)
def fusion_seqpool_concat(x, lod, pooltype="SUM", axis=1):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return torch.cat([_seq_pool_flat(xi, lod, pooltype) for xi in xs],
                     dim=axis)


@register_op(nondiff=True)
def fusion_seqpool_cvm_concat(x, cvm, lod, pooltype="SUM", use_cvm=True,
                              axis=1):
    return torch.cat(fused_seqpool_cvm._kernel(x, cvm, lod,
                                               pooltype=pooltype,
                                               use_cvm=use_cvm), dim=axis)


@register_op(nondiff=True)
def fusion_seqconv_eltadd_relu(x, filter, bias, lod, context_length=3,
                               context_start=0, context_stride=1):
    """relu(sequence_conv + bias)."""
    from .tail_r4 import sequence_conv

    conv = sequence_conv._kernel(x, filter, lod,
                                 context_length=context_length,
                                 context_start=context_start,
                                 context_stride=context_stride)
    return torch.relu(conv + bias.reshape(1, -1))


@register_op(nondiff=True)
def fusion_seqexpand_concat_fc(x, fc_weight, fc_bias, lod,
                               fc_activation="identity"):
    """x = [ref, extra...]: ref flat [N, D0]; each extra one row a
    sequence, broadcast over its rows; concatenated, then fc and act."""
    xs = list(x)
    lens = np.diff(_offsets(lod))
    rep = torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                          device=xs[0].device)
    h = torch.cat([xs[0]] + [e[rep] for e in xs[1:]], dim=1) @ fc_weight
    if fc_bias is not None:
        h = h + fc_bias.reshape(1, -1)
    return _ACTS[fc_activation](h)


@register_op(nondiff=True)
def attention_lstm(x, c0, h0, attention_weight, attention_bias,
                   attention_scalar, attention_scalar_bias, lstm_weight,
                   lstm_bias, lod, gate_activation="sigmoid",
                   cell_activation="tanh", candidate_activation="tanh"):
    """Attention-pooled LSTM: each step's input is the softmax-attention
    pool of its sequence (scores from the rows and the previous cell);
    lstm_weight [(D+M), 4D] (hidden rows first; gates f, i, o, c~).
    -> (hidden [T_total, D], cell [T_total, D])."""
    act_gate, act_cell, act_cand = (_ACTS[gate_activation],
                                    _ACTS[cell_activation],
                                    _ACTS[candidate_activation])
    off = _offsets(lod)
    M = x.shape[1]
    D = lstm_weight.shape[1] // 4
    atted = x @ attention_weight[:M]
    if attention_bias is not None:
        atted = atted + attention_bias.reshape(1, 1)
    w_cell = attention_weight[M:].reshape(D)
    hiddens, cells = [], []
    for i in range(len(off) - 1):
        s, e = int(off[i]), int(off[i + 1])
        xi, ai = x[s:e], atted[s:e, 0]
        c_prev = c0[i]
        h_prev = h0[i] if h0 is not None else torch.zeros(
            D, dtype=x.dtype, device=x.device)
        for _ in range(e - s):
            fc = torch.relu(ai + c_prev @ w_cell)
            if attention_scalar is not None:
                fc = fc * attention_scalar.reshape(())
                if attention_scalar_bias is not None:
                    fc = torch.relu(fc + attention_scalar_bias.reshape(()))
            lstm_x = torch.softmax(fc, dim=0) @ xi
            gates = (lstm_x @ lstm_weight[D:] + h_prev @ lstm_weight[:D]
                     + lstm_bias.reshape(-1))
            f = act_gate(gates[:D])
            inp = act_gate(gates[D:2 * D])
            o = act_gate(gates[2 * D:3 * D])
            c_prev = f * c_prev + inp * act_cand(gates[3 * D:])
            h_prev = act_cell(c_prev) * o
            hiddens.append(h_prev)
            cells.append(c_prev)
    return torch.stack(hiddens), torch.stack(cells)


@register_op(nondiff=True)
def fused_embedding_fc_lstm(ids, embeddings, weight_h, bias, h0, c0, lod,
                            use_peepholes=False, is_reverse=False,
                            gate_activation="sigmoid",
                            cell_activation="tanh",
                            candidate_activation="tanh"):
    """Embedding (the FC folded into the table) and an LSTM (gates c~, i,
    f, o). -> (hidden [T_total, D], cell [T_total, D], embedded rows)."""
    act_gate, act_cell, act_cand = (_ACTS[gate_activation],
                                    _ACTS[cell_activation],
                                    _ACTS[candidate_activation])
    off = _offsets(lod)
    D = weight_h.shape[0]
    xx = embeddings[ids.long().reshape(-1)] + bias.reshape(1, -1)
    hiddens, cells = [], []
    for i in range(len(off) - 1):
        s, e = int(off[i]), int(off[i + 1])
        steps = range(e - 1, s - 1, -1) if is_reverse else range(s, e)
        h_prev = h0[i] if h0 is not None else torch.zeros(
            D, dtype=xx.dtype, device=xx.device)
        c_prev = c0[i] if c0 is not None else torch.zeros(
            D, dtype=xx.dtype, device=xx.device)
        seq_h, seq_c = {}, {}
        for t in steps:
            gates = xx[t] + h_prev @ weight_h
            cand = act_cand(gates[:D])
            inp = act_gate(gates[D:2 * D])
            f = act_gate(gates[2 * D:3 * D])
            o = act_gate(gates[3 * D:])
            c_prev = inp * cand + f * c_prev
            h_prev = act_cell(c_prev) * o
            seq_h[t], seq_c[t] = h_prev, c_prev
        hiddens += [seq_h[t] for t in range(s, e)]
        cells += [seq_c[t] for t in range(s, e)]
    return torch.stack(hiddens), torch.stack(cells), xx


@register_op(nondiff=True)
def cudnn_lstm(x, init_h, init_c, w=None, weight_list=None,
               sequence_length=None, dropout_prob=0.0, is_bidirec=False,
               hidden_size=100, num_layers=1, is_test=False, seed=0):
    """The cuDNN LSTM name over the `rnn` op (time-major); weight_list
    the [w_ih, w_hh, b_ih, b_hh] bundles by (layer, direction)."""
    from .rnn_ops import rnn as _rnn

    if weight_list is None:
        raise NotImplementedError(
            "packed cudnn weight blob `w` is a cuDNN storage detail; pass "
            "weight_list=[[w_ih, w_hh, b_ih, b_hh], ...] (the reference's "
            "dygraph path does the same unpacking)")
    out, h, c = _rnn._kernel(x, init_h, init_c, list(weight_list),
                             mode="LSTM", is_bidirec=is_bidirec,
                             time_major=True)
    return out, h, c, torch.zeros(0, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def distributed_fused_lamb_init(param, grad, beta1=0.9, beta2=0.999,
                                apply_weight_decay=(), alignment=128,
                                rank=0, nranks=1):
    """The fused-LAMB flattening: each parameter aligned to `alignment`
    elements in one f32 buffer, zero moments, the bookkeeping tensors."""
    dev = param[0].device if len(param) else None
    align = max(int(alignment), 1)

    def flat(ts):
        parts = [F.pad(t.to(torch.float32).reshape(-1), (0, (-t.numel())
                                                         % align))
                 for t in ts]
        return torch.cat(parts) if parts else torch.zeros(0, device=dev)

    offsets, pos = [0], 0
    for p in param:
        pos += p.numel() + (-p.numel()) % align
        offsets.append(pos)
    fused_param, fused_grad = flat(param), flat(grad)
    z = torch.zeros_like(fused_param)
    off_t = torch.tensor(offsets, dtype=torch.int64, device=dev)
    return (fused_param, fused_grad,
            torch.zeros(0, dtype=torch.float16, device=dev),
            torch.zeros(0, dtype=torch.float16, device=dev), z, z,
            torch.full((1,), beta1, device=dev),
            torch.full((1,), beta2, device=dev), off_t, off_t,
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.tensor([len(param)], dtype=torch.int64, device=dev),
            torch.arange(len(param), dtype=torch.int64, device=dev),
            list(param), list(param), list(grad),
            torch.ones(1, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev))


@register_op
def legacy_bilinear_interp(x, out_h=0, out_w=0, align_corners=True,
                           align_mode=1, data_format="NCHW"):
    from .vision_ops import bilinear_interp

    return bilinear_interp._kernel(x, out_h, out_w,
                                   align_corners=align_corners,
                                   align_mode=align_mode)


@register_op
def legacy_nearest_interp(x, out_h=0, out_w=0, align_corners=True,
                          data_format="NCHW"):
    from .vision_ops import nearest_interp

    return nearest_interp._kernel(x, out_h, out_w,
                                  align_corners=align_corners)


@register_op(nondiff=True)
def legacy_generate_proposals(scores, bbox_deltas, im_info, anchors,
                              variances, pre_nms_top_n=6000,
                              post_nms_top_n=1000, nms_thresh=0.5,
                              min_size=0.1, eta=1.0):
    """v1 generate_proposals: im_info rows [h, w, scale]; the 1-pixel
    offset convention."""
    from .vision_ops import generate_proposals

    return generate_proposals._kernel(
        scores, bbox_deltas, im_info[:, :2], anchors, variances,
        pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
        nms_thresh=nms_thresh, min_size=min_size, eta=eta,
        pixel_offset=True)


@register_op(nondiff=True)
def pyramid_hash(x, w, white_list, black_list, lod, num_emb=8, space_len=100,
                 pyramid_layer=2, rand_len=4, drop_out_percent=0.0,
                 is_training=0, use_filter=False, white_list_len=0,
                 black_list_len=0, seed=0, lr=1.0, distribute_update_vars=""):
    """Hashed n-gram embeddings on the host: for each sequence and n-gram
    length 2..pyramid_layer, an n-gram's embedding is rand_len-slices of
    the flat table at its hashes (the reference's FNV-style hash); a
    sequence with no kept n-gram gives one zero row. white / black lists
    are id arrays. -> (top [rows, num_emb], drop_pos, x_temp)."""
    dev = w.device
    ids = _offsets(x)
    off = _offsets(lod)
    wt_flat = w.detach().cpu().numpy().astype(np.float32).reshape(-1)
    white = set(_offsets(white_list).tolist()) \
        if use_filter and white_list_len else None
    black = set(_offsets(black_list).tolist()) \
        if use_filter and black_list_len else None
    gen = rng.seed_or_next(int(seed), "cpu")

    def _hash(ngram, salt):
        h = np.uint64(1469598103934665603) ^ np.uint64(
            salt * 1099511628211 + 7)
        for v in ngram:
            h = np.uint64((int(h) ^ int(v)) * 1099511628211
                          & 0xFFFFFFFFFFFFFFFF)
        return int(h) % space_len

    if wt_flat.size < space_len + rand_len:
        wt_flat = np.pad(wt_flat, (0, space_len + rand_len - wt_flat.size))
    tops, drops = [], []
    for i in range(len(off) - 1):
        seq = ids[int(off[i]):int(off[i + 1])]
        kept = []
        for n in range(2, min(int(pyramid_layer) + 1, len(seq) + 1)):
            for start in range(len(seq) - n + 1):
                ng = tuple(seq[start:start + n].tolist())
                key = _hash(ng, 0)
                ok = not ((white is not None and key not in white)
                          or (black is not None and key in black))
                if ok and is_training and float(torch.rand(
                        (), generator=gen)) < drop_out_percent:
                    drops.append(0)
                    continue
                drops.append(1 if ok else 0)
                if not ok:
                    continue
                emb = np.concatenate(
                    [wt_flat[_hash(ng, j):_hash(ng, j) + int(rand_len)]
                     for j in range(0, int(num_emb), int(rand_len))])
                kept.append(emb[:num_emb])
        tops.append(np.stack(kept) if kept
                    else np.zeros((1, num_emb), np.float32))
    top = np.concatenate(tops) if tops else np.zeros((0, num_emb),
                                                     np.float32)
    return (torch.as_tensor(top, device=dev),
            torch.as_tensor(np.asarray(drops, np.int32), device=dev),
            torch.as_tensor(ids.astype(np.float32), device=dev))


@register_op
def yolo_box_head(x, anchors=(), class_num=1):
    """The YOLO head's activations: sigmoid of x, y, obj and the classes,
    exp of w, h. x [N, A*(5+C), H, W]."""
    N, CH, H, W = x.shape
    A = max(len(anchors) // 2, 1)
    t = x.reshape(N, A, 5 + int(class_num), H, W)
    return torch.cat([torch.sigmoid(t[:, :, 0:2]), torch.exp(t[:, :, 2:4]),
                      torch.sigmoid(t[:, :, 4:])], dim=2).reshape(N, CH, H, W)


@register_op(nondiff=True)
def yolo_box_post(boxes0, boxes1, boxes2, image_shape, image_scale,
                  anchors0=(), anchors1=(), anchors2=(), class_num=80,
                  conf_thresh=0.01, downsample_ratio0=8,
                  downsample_ratio1=16, downsample_ratio2=32,
                  clip_bbox=True, scale_x_y=1.0, nms_threshold=0.45):
    """Three YOLO heads decoded by yolo_box and merged, then a hard NMS of
    every class of an image at once; boxes divided by image_scale into the
    original image's coordinates. -> (out [M, 6] = [class, score, box],
    rois_num [N] int32)."""
    from .vision_ops import _argsort_desc, _greedy_nms, yolo_box

    dev = boxes0.device
    N = boxes0.shape[0]
    img_size = torch.as_tensor(image_shape, device=dev).to(torch.int32)
    scales = torch.as_tensor(image_scale).reshape(N, -1)[:, 0].tolist()
    heads = [(boxes0, list(anchors0), downsample_ratio0),
             (boxes1, list(anchors1), downsample_ratio1),
             (boxes2, list(anchors2), downsample_ratio2)]
    decoded = [yolo_box._kernel(h, img_size, a, class_num=class_num,
                                conf_thresh=conf_thresh, downsample_ratio=d,
                                clip_bbox=clip_bbox, scale_x_y=scale_x_y)
               for h, a, d in heads]
    boxes = torch.cat([b for b, _ in decoded], 1)              # [N, K, 4]
    scores = torch.cat([s for _, s in decoded], 1).transpose(1, 2)
    C, K = scores.shape[1], scores.shape[2]
    sc64 = scores.to(torch.float64)
    masked = torch.where(scores > conf_thresh, sc64,      # the f32 test
                         torch.tensor(float("-inf"), dtype=torch.float64,
                                      device=dev))
    order = _argsort_desc(masked)                               # [N, C, K]
    valid = torch.gather(masked, 2, order) > float("-inf")
    kept = _greedy_nms(
        boxes.to(torch.float64)[:, None].expand(N, C, K, 4).reshape(
            N * C, K, 4), order.reshape(N * C, K), valid.reshape(N * C, K),
        nms_threshold).reshape(N, C, K)
    order_h = order.cpu().numpy()
    boxes_h = boxes.cpu().numpy()
    scores_h = scores.cpu().numpy()
    rows, nums = [], []
    for i in range(N):
        ci, ki = np.nonzero(kept[i])
        j = order_h[i, ci, ki]
        sc = max(scales[i], 1e-9)
        rows.append(np.concatenate(
            [ci[:, None].astype(np.float32), scores_h[i, ci, j][:, None],
             boxes_h[i, j] / np.float32(sc)], axis=1))
        nums.append(len(j))
    out = np.concatenate(rows).astype(np.float32) if rows else \
        np.zeros((0, 6), np.float32)
    return (torch.as_tensor(out, device=dev),
            torch.as_tensor(np.asarray(nums, np.int32), device=dev))
