"""Op tail 9 — port of `paddle_tpu/ops/kernels/tail_r5c.py`.

Legacy optimizer updates (functional: they return the new states),
legacy aliases and plumbing, and the structured ops gru_unit,
quant_linear, rank_attention, the TDM tree ops, match_matrix_tensor and
collect_fpn_proposals. `dpsgd` and `tdm_sampler` draw from the port's
generators.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ..dispatch import OPS, register_op

# ---------------------------------------------------------------------------
# optimizer updates
# ---------------------------------------------------------------------------


@register_op(name="decayed_adagrad", nondiff=True)
def decayed_adagrad(param, grad, moment, learning_rate, decay=0.95,
                    epsilon=1e-6):
    m = decay * moment + (1 - decay) * grad * grad
    return param - learning_rate * grad / (torch.sqrt(m) + epsilon), m


@register_op(name="ftrl", nondiff=True)
def ftrl(param, squared_accumulator, linear_accumulator, grad, learning_rate,
         l1=0.0, l2=0.0, lr_power=-0.5):
    """The legacy name of `ftrl_`'s update."""
    from .tail_math import ftrl_

    return ftrl_._kernel(param, squared_accumulator, linear_accumulator,
                         grad, learning_rate, l1=l1, l2=l2,
                         lr_power=lr_power)


@register_op(name="dpsgd", nondiff=True)
def dpsgd(param, grad, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
          seed=0):
    """Clip the gradient's global norm to `clip`, add one shared gaussian
    draw scaled by sigma / batch_size."""
    l2 = torch.sqrt((grad.to(torch.float32) ** 2).sum())
    scale = torch.where(l2 > clip, l2 / clip,
                        torch.ones((), device=l2.device)).to(param.dtype)
    noise = sigma * torch.randn((), generator=rng.seed_or_next(
        int(seed), param.device), device=param.device)
    return param - learning_rate * (grad / scale
                                    + noise.to(param.dtype) / batch_size)


@register_op(name="rprop_", nondiff=True)
def rprop_(param, grad, prev, learning_rate, learning_rate_range, etas):
    """Per-element rates scaled by eta+ / eta- as the gradient's sign
    agrees or flips, clipped to [lr_min, lr_max]; a flip zeroes the
    applied gradient."""
    lr_min, lr_max = learning_rate_range[0], learning_rate_range[1]
    eta_neg, eta_pos = etas[0], etas[1]
    prod = grad * prev
    one = torch.ones_like(prod)
    eta = torch.where(prod > 0, eta_pos * one,
                      torch.where(prod < 0, eta_neg * one, one))
    g = torch.where(prod < 0, torch.zeros_like(grad), grad)
    lr = torch.minimum(torch.maximum(learning_rate * eta,
                                     torch.as_tensor(lr_min).to(prod)),
                       torch.as_tensor(lr_max).to(prod))
    return param - torch.sign(g) * lr, g, lr


@register_op(name="sparse_momentum", nondiff=True)
def sparse_momentum(param, grad, velocity, index, learning_rate, mu=0.9,
                    use_nesterov=False, regularization_method="",
                    regularization_coeff=0.0, axis=0):
    """Momentum on the rows named by `index` along `axis` (grad has the
    gathered shape); the other rows keep their values."""
    axis = int(axis)
    idx = torch.as_tensor(index, device=param.device).long().reshape(-1)
    p_rows = param.index_select(axis, idx)
    v_rows = velocity.index_select(axis, idx)
    g = grad
    if regularization_method == "l2_decay":
        g = g + regularization_coeff * p_rows
    v_new = mu * v_rows + g
    step = g + mu * v_new if use_nesterov else v_new
    p_new = p_rows - learning_rate * step
    return (param.index_copy(axis, idx, p_new),
            velocity.index_copy(axis, idx, v_new))


@register_op(name="average_accumulates_", nondiff=True)
def average_accumulates_(param, in_sum_1, in_sum_2, in_sum_3,
                         in_num_accumulates, in_old_num_accumulates,
                         in_num_updates, average_window=0.0,
                         max_average_window=16384, min_average_window=10000):
    """The ASGD window accumulators: sum_1 spills into sum_2 every 16384
    updates; a full window moves sum_1 + sum_2 into sum_3."""
    k_max = 16384
    num_updates = in_num_updates.reshape(()) + 1
    num_acc = in_num_accumulates.reshape(()) + 1
    old_num_acc = in_old_num_accumulates.reshape(())
    sum_1 = in_sum_1 + param
    spill = num_updates % k_max == 0
    sum_2 = torch.where(spill, in_sum_2 + sum_1, in_sum_2)
    sum_1 = torch.where(spill, torch.zeros_like(sum_1), sum_1)
    window = torch.minimum(
        torch.tensor(float(max_average_window), device=param.device),
        num_updates.to(torch.float32) * average_window)
    flush = (num_acc >= min_average_window) & (num_acc.to(torch.float32)
                                               >= window)
    sum_3 = torch.where(flush, sum_1 + sum_2, in_sum_3)
    sum_1 = torch.where(flush, torch.zeros_like(sum_1), sum_1)
    sum_2 = torch.where(flush, torch.zeros_like(sum_2), sum_2)
    old_num_acc = torch.where(flush, num_acc, old_num_acc)
    num_acc = torch.where(flush, torch.zeros_like(num_acc), num_acc)
    return (sum_1, sum_2, sum_3,
            num_acc.reshape(in_num_accumulates.shape),
            old_num_acc.reshape(in_old_num_accumulates.shape),
            num_updates.reshape(in_num_updates.shape))


# ---------------------------------------------------------------------------
# legacy aliases / plumbing
# ---------------------------------------------------------------------------


@register_op
def divide_scalar(x, scalar=1.0):
    return x / scalar


@register_op
def flatten2(x, axis=1):
    """(out, xshape), xshape leading with a 0."""
    lead = int(np.prod(x.shape[:int(axis)], dtype=np.int64))
    return x.reshape(lead, -1), torch.zeros((0,) + tuple(x.shape),
                                            dtype=x.dtype, device=x.device)


@register_op
def matmul_with_flatten(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The fluid `mul`: both operands flattened to 2-D, the leading dims
    restored on the output."""
    xs, ys = x.shape, y.shape
    xm = int(np.prod(xs[:x_num_col_dims], dtype=np.int64))
    xk = int(np.prod(xs[x_num_col_dims:], dtype=np.int64))
    yk = int(np.prod(ys[:y_num_col_dims], dtype=np.int64))
    yn = int(np.prod(ys[y_num_col_dims:], dtype=np.int64))
    out = x.reshape(xm, xk) @ y.reshape(yk, yn)
    return out.reshape(tuple(xs[:x_num_col_dims]) + tuple(ys[y_num_col_dims:]))


@register_op
def maxpool(x, kernel_size, strides=None, paddings=0, ceil_mode=False,
            data_format="NCHW"):
    """Legacy max pool2d."""
    return OPS["pool2d"]._kernel(x, kernel_size, strides=strides,
                                 paddings=paddings, ceil_mode=ceil_mode,
                                 pooling_type="max", data_format=data_format)


@register_op
def topk_v1(x, k=1):
    vals, idx = torch.topk(x, int(k), dim=-1)
    return vals, idx.long()


@register_op
def legacy_expand(x, expand_times):
    """Repeat counts an axis (tile)."""
    return x.repeat(tuple(int(t) for t in expand_times))


@register_op
def legacy_crop(x, shape, offsets=None):
    offsets = (0,) * x.ndim if offsets is None else tuple(int(o)
                                                          for o in offsets)
    return x[tuple(slice(o, o + int(s)) for o, s in zip(offsets, shape))]


@register_op(nondiff=True)
def merge_selected_rows(ids, values):
    """Sum duplicate rows: -> (unique ids ascending, summed rows)."""
    uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                             return_inverse=True)
    out = torch.zeros((uniq.shape[0],) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return uniq, out.index_add(0, inv, values)


@register_op(name="batch_norm_", nondiff=False)
def batch_norm_(x, mean, variance, scale=None, bias=None, is_test=False,
                momentum=0.9, epsilon=1e-5, data_format="NCHW",
                use_global_stats=False, trainable_statistics=False):
    """The `_` name of batch_norm (functional)."""
    return OPS["batch_norm"]._kernel(
        x, mean, variance, scale=scale, bias=bias, is_test=is_test,
        momentum=momentum, epsilon=epsilon, data_format=data_format,
        use_global_stats=use_global_stats,
        trainable_statistics=trainable_statistics)


@register_op(nondiff=True)
def check_numerics(x, op_type="", var_name="", check_nan_inf_level=0,
                   stack_height_limit=-1, output_dir=""):
    """(stats [#nan, #inf, #zero] int64, values [max, min, mean] over the
    finite entries)."""
    xf = x.to(torch.float32)
    nan, inf = torch.isnan(xf), torch.isinf(xf)
    bad = nan | inf
    stats = torch.stack([nan.sum(), inf.sum(), (x == 0).sum()]).long()
    n_ok = torch.clamp((~bad).sum(), min=1)
    ninf = torch.tensor(float("-inf"), device=x.device)
    values = torch.stack([
        torch.where(bad, ninf, xf).max(),
        torch.where(bad, -ninf, xf).min(),
        torch.where(bad, torch.zeros_like(xf), xf).sum() / n_ok])
    return stats, values


# ---------------------------------------------------------------------------
# structured ops
# ---------------------------------------------------------------------------

_GRU_ACTS = {0: lambda v: v, 1: torch.sigmoid, 2: torch.tanh, 3: torch.relu}


@register_op
def gru_unit(input, hidden_prev, weight, bias=None, activation=2,
             gate_activation=1, origin_mode=False):
    """One GRU cell step: input [B, 3D] (x @ W_x), hidden_prev [B, D],
    weight [D, 3D] = [W_update | W_reset | W_candidate]. -> (gate,
    reset_hidden_prev, hidden)."""
    B, D = hidden_prev.shape
    act = _GRU_ACTS[int(activation)]
    gate_act = _GRU_ACTS[int(gate_activation)]
    g = input if bias is None else input + bias.reshape(1, 3 * D)
    g = torch.cat([g[:, :2 * D] + hidden_prev @ weight[:, :2 * D],
                   g[:, 2 * D:]], 1)
    u = gate_act(g[:, :D])
    r = gate_act(g[:, D:2 * D])
    rhp = r * hidden_prev
    c = act(g[:, 2 * D:] + rhp @ weight[:, 2 * D:])
    h = c + u * (hidden_prev - c) if origin_mode \
        else u * (c - hidden_prev) + hidden_prev
    return torch.cat([u, r, c], 1), rhp, h


@register_op
def quant_linear(x, w, bias=None, in_num_col_dims=1, activation_type="",
                 padding_weights=False, scale_in=1.0, scale_weights=(1.0,),
                 quant_round_type=1, quant_max_bound=127.0,
                 quant_min_bound=-127.0):
    """Quantized FC: x_q = clip(round(max_bound * scale_in * x)), acc =
    x_q @ w (int8 values, exact in f32), out = acc / (max_bound^2 *
    scale_in * scale_w[col]) + bias, then relu if asked."""
    if padding_weights:
        w = w[:-4, :-4]
    xs = x.shape
    m = int(np.prod(xs[:in_num_col_dims], dtype=np.int64))
    k = int(np.prod(xs[in_num_col_dims:], dtype=np.int64))
    q = quant_max_bound * scale_in * x.reshape(m, k).to(torch.float32)
    q = torch.round(q) if int(quant_round_type) == 0 \
        else torch.trunc(q + torch.sign(q) * 0.5)
    q = torch.clamp(q, quant_min_bound, quant_max_bound)
    acc = q @ w.to(torch.float32)
    sw = torch.as_tensor(scale_weights, dtype=torch.float32,
                         device=x.device).reshape(1, -1)
    out = acc / (quant_max_bound * quant_max_bound * scale_in * sw)
    if bias is not None:
        out = out + bias.reshape(1, -1).to(out.dtype)
    if activation_type == "relu":
        out = torch.relu(out)
    return out.to(x.dtype).reshape(tuple(xs[:in_num_col_dims])
                                   + (w.shape[1],))


@register_op
def rank_attention(x, rank_offset, rank_param, max_rank=3, max_size=0):
    """Rank-selected parameter blocks: out[i] = sum_k x[idx_k] @
    W[lower_i * K + faster_k]. -> (input_help [N, K*d], out [N, p],
    ins_rank [N, 1])."""
    N, d = x.shape
    K = int(max_rank)
    p = rank_param.shape[-1]
    ro = rank_offset.long()
    lower = ro[:, 0] - 1
    faster = ro[:, 1::2][:, :K] - 1
    index = ro[:, 2::2][:, :K]
    valid = (lower[:, None] >= 0) & (faster >= 0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xk = torch.where(valid[..., None], x[index.clamp(0, N - 1)], zero)
    bidx = torch.clamp(lower[:, None] * K + faster, 0, K * K - 1)
    wk = torch.where(valid[..., None, None],
                     rank_param.reshape(K * K, d, p)[bidx], zero)
    out = torch.einsum("nkd,nkdp->np", xk, wk)
    return xk.reshape(N, K * d), out, ro[:, :1].to(x.dtype)


@register_op(nondiff=True)
def tdm_child(x, tree_info, child_nums=2):
    """Child lookup in the TDM tree table (rows [item, layer, ancestor,
    child...]). -> (child, mask) shaped x.shape + (child_nums,)."""
    ids = x.long()
    info = tree_info.long()
    C = int(child_nums)
    flat = ids.reshape(-1)
    rows = info[flat]
    has_child = (flat != 0) & (rows[:, 3] != 0)
    children = torch.where(has_child[:, None], rows[:, 3:3 + C],
                           torch.zeros((), dtype=torch.long,
                                       device=ids.device))
    child_item = info[:, 0][children.clamp(0, info.shape[0] - 1)]
    mask = (has_child[:, None] & (children != 0) & (child_item != 0)).to(
        torch.int32)
    shape = tuple(ids.shape) + (C,)
    return children.reshape(shape).to(torch.int32), mask.reshape(shape)


@register_op(nondiff=True)
def tdm_sampler(x, travel, layer, neg_samples_num_list=(1,),
                layer_offset_lod=(0, 1), output_positive=True, seed=0):
    """Layer-wise TDM sampling along each id's travel path: the positive
    (optional) and uniform negatives of its layer, the positive excluded
    by shifting past its slot; padding layers give zeros with mask 0.
    -> (out, labels, mask) int32."""
    dev = x.device
    ids = x.long().reshape(-1)
    trav = travel.long()
    lay = layer.long().reshape(-1)
    offs = [int(v) for v in layer_offset_lod]
    gen = rng.seed_or_next(int(seed), dev)
    outs, labels, masks = [], [], []
    for li, neg in enumerate(int(n) for n in neg_samples_num_list):
        lo, hi = offs[li], offs[li + 1]
        n_nodes = hi - lo
        pos = trav[ids, li]
        alive = (pos != 0).long()
        if output_positive:
            outs.append(pos[:, None])
            labels.append(alive[:, None])
            masks.append(alive[:, None])
        draw = torch.randint(0, max(n_nodes - 1, 1), (ids.shape[0], neg),
                             generator=gen, device=dev)
        pos_slot = torch.argmax((lay[lo:hi][None, :] == pos[:, None]).long(),
                                dim=1)
        draw = torch.where(draw >= pos_slot[:, None], draw + 1, draw)
        neg_ids = lay[lo:hi][draw.clamp(0, n_nodes - 1)] * alive[:, None]
        outs.append(neg_ids)
        labels.append(torch.zeros_like(neg_ids))
        masks.append(alive[:, None].expand(-1, neg))
    return tuple(torch.cat(v, 1).to(torch.int32)
                 for v in (outs, labels, masks))


@register_op
def match_matrix_tensor(x, y, w, x_lod, y_lod, dim_t=1):
    """Per segment pair i and channel t: (x_i @ W_t) @ y_i^T, flattened.
    -> (out [sum lx*ly*dim_t, 1], x @ W flattened [N*dim_t*d, 1])."""
    x_off = np.asarray(x_lod, np.int64).reshape(-1)
    y_off = np.asarray(y_lod, np.int64).reshape(-1)
    d = x.shape[1]
    xw = torch.einsum("nd,dte->nte", x, w.reshape(d, int(dim_t), -1))
    outs = []
    for i in range(len(x_off) - 1):
        seg = torch.einsum("lte,me->tlm", xw[x_off[i]:x_off[i + 1]],
                           y[y_off[i]:y_off[i + 1]])
        outs.append(seg.reshape(-1))
    return torch.cat(outs).reshape(-1, 1), xw.reshape(-1, 1)


@register_op(nondiff=True)
def collect_fpn_proposals(multi_rois, multi_scores, rois_num_per_level,
                          post_nms_topn=100):
    """Concatenate the levels' RoIs, keep the global top post_nms_topn by
    score (ties by position), regroup by image. -> (fpn_rois [M, 4],
    rois_num [B] int32)."""
    dev = multi_rois[0].device
    rois = torch.cat([r.to(torch.float32).reshape(-1, 4)
                      for r in multi_rois])
    scores = torch.cat([s.to(torch.float32).reshape(-1)
                        for s in multi_scores])
    nums = [n.long().reshape(-1) for n in rois_num_per_level]
    B = nums[0].shape[0]
    bids = torch.cat([torch.repeat_interleave(torch.arange(B, device=dev), n)
                      for n in nums])
    keep = torch.argsort(-scores, stable=True)[:int(post_nms_topn)]
    keep = keep[torch.argsort(bids[keep], stable=True)]
    return rois[keep], torch.bincount(bids[keep], minlength=B).to(
        torch.int32)
