"""Op tail: shape and indexing, pooling and resampling, sequence, graph
and sampling ops — port of `paddle_tpu/ops/kernels/tail_nn.py`.

- `fold` is torch's col2im; the unpools scatter by the flat indices.
- fractional pooling takes its static index sequences at call time.
- graph message passing (the send_u_recv family) and the segment ops
  reduce with `index_add_` / `scatter_reduce` (empty segments: 0 for a
  sum, -inf / +inf for max / min, as jax's segment ops give).
- The data-dependent ops run where their tensors are:
  `unique_consecutive` and `repeat_interleave_with_tensor_index` are
  torch's own; `ctc_align` keeps its tokens by a mask and a cumulative
  sum; `edit_distance` runs the Levenshtein recursion a row at a time,
  each row one running minimum (`cummin`) over the batch. Outputs and
  types are the reference's host loops'.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core import rng
from ..dispatch import register_op
from ._util import device, pair, td

# ---------------------------------------------------------------------------
# shape / indexing
# ---------------------------------------------------------------------------


@register_op
def fill(x, value=0.0):
    return torch.full_like(x, value)


@register_op
def fill_diagonal(x, value=0.0, offset=0, wrap=False):
    """Fill the diagonal of the last two axes (numpy's wrapped diagonal
    for a tall matrix with wrap)."""
    H, W = x.shape[-2], x.shape[-1]
    i = torch.arange(H, device=x.device)[:, None]
    j = torch.arange(W, device=x.device)[None, :]
    mask = (j - i) == offset
    if wrap and x.ndim == 2 and H > W:
        mask = (torch.remainder(j - i, W + 1) == offset) & ((j - i) <= offset)
        mask = torch.remainder(i, W + 1) == (j - offset) if offset >= 0 \
            else mask
        mask = (torch.remainder(i - offset, W + 1) == j) if offset <= 0 \
            else mask
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


@register_op
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    """Write y along the (dim1, dim2) diagonal."""
    x2 = torch.movedim(x, (dim1, dim2), (-2, -1)).clone()
    H, W = x2.shape[-2], x2.shape[-1]
    n = min(H, W - offset) if offset >= 0 else min(H + offset, W)
    i = torch.arange(n, device=x.device) + max(-offset, 0)
    j = torch.arange(n, device=x.device) + max(offset, 0)
    x2[..., i, j] = y.to(x.dtype)
    return torch.movedim(x2, (-2, -1), (dim1, dim2))


@register_op
def index_put(x, indices, value, accumulate=False):
    idx = tuple(indices) if isinstance(indices, (list, tuple)) else (indices,)
    idx = tuple(i.long() if not i.dtype == torch.bool else i for i in idx)
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.index_put(x, idx, value, accumulate=accumulate)


@register_op
def reverse(x, axis):
    return torch.flip(x, dims=tuple(axis) if isinstance(axis, (list, tuple))
                      else (axis,))


@register_op
def unstack(x, axis=0, num=None):
    return list(torch.unbind(x, dim=axis))


@register_op
def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*inputs))


@register_op(nondiff=True)
def sequence_mask(x, maxlen=None, out_dtype="int64"):
    if maxlen is None:
        raise ValueError("sequence_mask needs a static maxlen under jit; "
                         "pass maxlen explicitly")
    m = int(maxlen)
    return (torch.arange(m, device=x.device) < x[..., None]).to(
        td(out_dtype))


@register_op
def strided_slice(x, axes, starts, ends, strides):
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx = range(*slice(s, e, st).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(list(idx),
                                                   dtype=torch.long,
                                                   device=x.device))
    return x


@register_op
def split_with_num(x, num, axis=0):
    return list(torch.split(x, x.shape[axis] // num, dim=axis))


@register_op
def crop(x, shape, offsets=None):
    offsets = offsets or [0] * x.ndim
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@register_op
def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    """paddings [left, right, top, bottom, front, back]."""
    p = [int(v) for v in paddings]
    last = data_format != "NCDHW"
    if last:
        x = x.permute(0, 4, 1, 2, 3)
    if mode == "constant":
        out = F.pad(x, p, value=value)
    else:
        out = F.pad(x, p, mode=mode)
    return out.permute(0, 2, 3, 4, 1) if last else out


@register_op(nondiff=True)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64"):
    """Collapse consecutive repeats (along `axis`, slices at a time)."""
    out, inv, counts = torch.unique_consecutive(
        x.reshape(-1) if axis is None else x, return_inverse=True,
        return_counts=True, dim=None if axis is None else axis)
    res = [out]
    if return_inverse:
        res.append(inv.reshape(-1).to(td(dtype)))
    if return_counts:
        res.append(counts.to(td(dtype)))
    return tuple(res) if len(res) > 1 else res[0]


@register_op(nondiff=True)
def repeat_interleave_with_tensor_index(x, repeats, axis=0):
    return torch.repeat_interleave(x, repeats.long(), dim=axis)


@register_op(nondiff=True)
def shuffle_channel(x, group=1):
    N, C, H, W = x.shape
    return x.reshape(N, group, C // group, H, W).transpose(1, 2).reshape(
        N, C, H, W)


@register_op(nondiff=True)
def partial_sum(inputs, start_index=0, length=-1):
    end = None if length < 0 else start_index + length
    return sum(i[:, start_index:end] for i in inputs)


@register_op(nondiff=True)
def partial_concat(inputs, start_index=0, length=-1):
    end = None if length < 0 else start_index + length
    return torch.cat([i[:, start_index:end] for i in inputs], dim=1)


# ---------------------------------------------------------------------------
# pooling / resampling / im2col
# ---------------------------------------------------------------------------


@register_op
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im: x [N, C*kh*kw, L] -> [N, C, H, W], the overlaps summed."""
    return F.fold(x, pair(output_sizes), pair(kernel_sizes),
                  dilation=pair(dilations), padding=pair(paddings),
                  stride=pair(strides))


def _unpool_nd(x, indices, output_size):
    N, C = x.shape[:2]
    flat = int(np.prod(output_size))
    out = torch.zeros(N, C, flat, dtype=x.dtype, device=x.device)
    out = out.scatter(2, indices.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return out.reshape((N, C) + tuple(output_size))


@register_op
def unpool(x, indices, kernel_size=2, stride=None, padding=0,
           output_size=None, data_format="NCHW"):
    """Max-unpooling 2D from max_pool2d_with_index's flat indices."""
    if output_size is None:
        k = pair(kernel_size)
        s = pair(stride or kernel_size)
        H, W = x.shape[2], x.shape[3]
        output_size = ((H - 1) * s[0] + k[0], (W - 1) * s[1] + k[1])
    return _unpool_nd(x, indices, tuple(output_size)[-2:])


@register_op
def unpool3d(x, indices, kernel_size=2, stride=None, padding=0,
             output_size=None, data_format="NCDHW"):
    if output_size is None:
        k = pair(kernel_size, 3)
        s = pair(stride or kernel_size, 3)
        D, H, W = x.shape[2], x.shape[3], x.shape[4]
        output_size = ((D - 1) * s[0] + k[0], (H - 1) * s[1] + k[1],
                       (W - 1) * s[2] + k[2])
    return _unpool_nd(x, indices, tuple(output_size)[-3:])


@register_op
def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW"):
    """(sum |x|^p)^(1/p) over windows."""
    k = pair(kernel_size)
    s = pair(stride or kernel_size)
    p = pair(padding)
    xf = F.pad(x.to(torch.float32).abs() ** norm_type,
               (p[1], p[1], p[0], p[0]))
    acc = F.avg_pool2d(xf, k, s, divisor_override=1)
    return (acc ** (1.0 / norm_type)).to(x.dtype)


def _fractional_bounds(in_size, out_size, u=0.5):
    """The static index sequence idx_i = ceil(alpha*(i+u)) - 1, alpha =
    in/out, with the ends pinned to 0 and in_size."""
    alpha = in_size / out_size
    idx = [int(np.ceil(alpha * (i + u))) - 1 for i in range(out_size + 1)]
    idx[0] = 0
    idx[-1] = in_size
    return idx


def _windowed_argmax(x, bounds, out, axis):
    """(max, absolute argmax) over each [bounds[i], bounds[i+1]) window
    along `axis`."""
    vals, idxs = [], []
    for i in range(out):
        lo, hi = bounds[i], max(bounds[i + 1], bounds[i] + 1)
        sl = x.narrow(axis, lo, hi - lo)
        vals.append(sl.amax(dim=axis))
        idxs.append(torch.argmax(sl, dim=axis) + lo)
    return torch.stack(vals, dim=axis), torch.stack(idxs, dim=axis)


def _window_max(x, bounds, out, axis):
    return torch.stack([x.narrow(axis, bounds[i],
                                 max(bounds[i + 1], bounds[i] + 1)
                                 - bounds[i]).amax(dim=axis)
                        for i in range(out)], dim=axis)


@register_op
def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False):
    oh, ow = pair(output_size)
    u = 0.5 if random_u is None else float(random_u)
    hb = _fractional_bounds(x.shape[2], oh, u)
    wb = _fractional_bounds(x.shape[3], ow, u)
    if return_mask:
        W = x.shape[3]
        rv, ri = _windowed_argmax(x, hb, oh, axis=2)
        cv, ci = _windowed_argmax(rv, wb, ow, axis=3)
        row_at_c = torch.gather(ri, 3, ci)
        return cv, (row_at_c * W + ci).long()
    return _window_max(_window_max(x, hb, oh, 2), wb, ow, 3)


@register_op
def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False):
    od, oh, ow = pair(output_size, 3)
    u = 0.5 if random_u is None else float(random_u)
    D, H, W = x.shape[2], x.shape[3], x.shape[4]
    db = _fractional_bounds(D, od, u)
    hb = _fractional_bounds(H, oh, u)
    wb = _fractional_bounds(W, ow, u)
    if return_mask:
        dv, di = _windowed_argmax(x, db, od, axis=2)        # [N,C,od,H,W]
        hv, hi = _windowed_argmax(dv, hb, oh, axis=3)       # [N,C,od,oh,W]
        wv, wi = _windowed_argmax(hv, wb, ow, axis=4)       # [N,C,od,oh,ow]
        h_at_w = torch.gather(hi, 4, wi)
        d_at_hw = torch.gather(torch.gather(di, 3, hi), 4, wi)
        return wv, ((d_at_hw * H + h_at_w) * W + wi).long()
    return _window_max(_window_max(_window_max(x, db, od, 2), hb, oh, 3),
                       wb, ow, 4)


@register_op
def max_pool3d_with_index(x, kernel_size, stride=None, padding=0,
                          global_pooling=False, adaptive=False):
    """3-D max pool with the flat argmax (first maximum of a window)."""
    k = pair(kernel_size, 3)
    s = pair(stride or kernel_size, 3)
    p = pair(padding, 3)
    N, C, D, H, W = x.shape
    if global_pooling:
        k, s, p = (D, H, W), (1, 1, 1), (0, 0, 0)
    neg = torch.finfo(torch.float32).min / 4
    xp = F.pad(x.to(torch.float32), (p[2], p[2], p[1], p[1], p[0], p[0]),
               value=neg)
    win = xp.unfold(2, k[0], s[0]).unfold(3, k[1], s[1]).unfold(
        4, k[2], s[2])                               # [N,C,Do,Ho,Wo,kd,kh,kw]
    Do, Ho, Wo = win.shape[2:5]
    win = win.reshape(N, C, Do, Ho, Wo, -1)
    out = win.amax(dim=-1).to(x.dtype)
    arg = torch.argmax(win, dim=-1)
    kz = arg // (k[1] * k[2])
    ky = (arg // k[2]) % k[1]
    kx = arg % k[2]
    dev = x.device
    dzi = torch.arange(Do, device=dev)[:, None, None] * s[0] + kz - p[0]
    dyi = torch.arange(Ho, device=dev)[None, :, None] * s[1] + ky - p[1]
    dxi = torch.arange(Wo, device=dev)[None, None, :] * s[2] + kx - p[2]
    return out, ((dzi * H + dyi) * W + dxi).long()


def _cubic_w(t, a=-0.75):
    t = t.abs()
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = (((t - 5) * t + 8) * t - 4) * a
    return torch.where(t <= 1, w1, torch.where(t < 2, w2,
                                               torch.zeros_like(t)))


@register_op
def bicubic_interp(x, out_h, out_w, align_corners=True):
    """Separable cubic-convolution resize (a = -0.75)."""
    N, C, H, W = x.shape
    dev = x.device

    def positions(out_s, in_s):
        o = torch.arange(out_s, dtype=torch.float32, device=dev)
        if align_corners and out_s > 1:
            return o * (in_s - 1) / (out_s - 1)
        return (o + 0.5) * in_s / out_s - 0.5

    def gather_axis(arr, pos, size, axis):
        base = torch.floor(pos).long()
        total = None
        shape = [1] * arr.ndim
        shape[axis] = -1
        for off in (-1, 0, 1, 2):
            idx = torch.clamp(base + off, 0, size - 1)
            piece = torch.index_select(arr, axis, idx) * _cubic_w(
                pos - (base + off)).reshape(shape)
            total = piece if total is None else total + piece
        return total

    out = gather_axis(gather_axis(x.to(torch.float32), positions(out_h, H),
                                  H, 2), positions(out_w, W), W, 3)
    return out.to(x.dtype)


@register_op
def trilinear_interp(x, out_d, out_h, out_w, align_corners=True,
                     align_mode=1):
    """3-D linear resize, one axis at a time."""
    N, C, D, H, W = x.shape
    dev = x.device

    def positions(out_s, in_s):
        o = torch.arange(out_s, dtype=torch.float32, device=dev)
        if align_corners and out_s > 1:
            return o * (in_s - 1) / (out_s - 1)
        if align_mode == 1:
            return (o * in_s / out_s).clamp(0, in_s - 1)
        return ((o + 0.5) * in_s / out_s - 0.5).clamp(0, in_s - 1)

    def lerp_axis(arr, pos, size, axis):
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=size - 1)
        w = pos - lo
        shape = [1] * arr.ndim
        shape[axis] = -1
        return (torch.index_select(arr, axis, lo) * (1 - w).reshape(shape)
                + torch.index_select(arr, axis, hi) * w.reshape(shape))

    xf = x.to(torch.float32)
    xf = lerp_axis(xf, positions(out_d, D), D, 2)
    xf = lerp_axis(xf, positions(out_h, H), H, 3)
    xf = lerp_axis(xf, positions(out_w, W), W, 4)
    return xf.to(x.dtype)


@register_op
def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    """weight / sigma, sigma from power iteration."""
    w = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
    for _ in range(max(power_iters, 0)):
        v = w.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = w @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u @ w @ v
    return weight / (sigma + eps)


# ---------------------------------------------------------------------------
# sequence / graph / decode
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def gather_tree(ids, parents):
    """Beam-search backtrace: ids/parents [T, B, beam] -> paths."""
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], device=ids.device)[None, :].expand(
        ids.shape[1], -1)
    outs = []
    for t in range(T - 1, -1, -1):
        outs.append(torch.gather(ids[t], -1, beam))
        beam = torch.gather(parents[t], -1, beam)
    return torch.stack(outs[::-1])


@register_op(nondiff=True)
def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None,
                  normalized=True):
    """Levenshtein distance a row: -> (distances [B, 1] f32, B as int64).
    Row i of the table is min_k<=j (t_k + j - k) with t the row's
    substitution and deletion steps, one cummin over the batch."""
    dev = hyps.device
    B, M = hyps.shape
    N = refs.shape[1]
    hl = (hyp_lengths.reshape(-1).long() if hyp_lengths is not None
          else torch.full((B,), M, dtype=torch.long, device=dev))
    rl = (ref_lengths.reshape(-1).long() if ref_lengths is not None
          else torch.full((B,), N, dtype=torch.long, device=dev))
    cols = torch.arange(N + 1, device=dev)
    dp = cols[None, :].expand(B, N + 1).clone()
    for i in range(1, M + 1):
        cost = (hyps[:, i - 1:i] != refs).long()               # [B, N]
        t = torch.cat([torch.full((B, 1), i, dtype=torch.long, device=dev),
                       torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + cost)], 1)
        row = torch.cummin(t - cols, dim=1).values + cols
        dp = torch.where((i <= hl)[:, None], row, dp)
    d = torch.gather(dp, 1, rl[:, None]).to(torch.float64)
    if normalized:
        d = d / torch.clamp(rl[:, None], min=1).to(torch.float64)
    return d.to(torch.float32), torch.tensor(B, dtype=torch.int64,
                                             device=dev)


@register_op(nondiff=True)
def ctc_align(input, input_length=None, blank=0, merge_repeated=True,
              padding_value=0):
    """Collapse repeats and strip blanks, padded back to the input's width
    with padding_value."""
    a = input
    B, T = a.shape
    dev = a.device
    lens = (input_length.reshape(-1).long() if input_length is not None
            else torch.full((B,), T, dtype=torch.long, device=dev))
    t = torch.arange(T, device=dev)
    keep = (t < lens[:, None]) & (a != blank)
    if merge_repeated:
        keep[:, 1:] &= a[:, 1:] != a[:, :-1]
    pos = torch.where(keep, torch.cumsum(keep.long(), 1) - 1, T)
    out = torch.full((B, T + 1), padding_value, dtype=a.dtype, device=dev)
    out.scatter_(1, pos, torch.where(keep, a, torch.as_tensor(
        padding_value, dtype=a.dtype, device=dev)))
    return out[:, :T]


@register_op
def sequence_pool(x, lengths, pool_type="SUM"):
    """Masked pooling over time on the padded [B, T, D] layout."""
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None])[..., None]
    pt = pool_type.upper()
    n = torch.clamp(lengths[:, None], min=1).to(x.dtype)
    if pt == "SUM":
        return (x * mask).sum(1)
    if pt == "AVERAGE":
        return (x * mask).sum(1) / n
    if pt == "SQRT":
        return (x * mask).sum(1) / torch.sqrt(n)
    if pt == "MAX":
        return torch.where(mask, x, torch.full((), float("-inf"),
                                               dtype=x.dtype,
                                               device=x.device)).amax(1)
    if pt == "FIRST":
        return x[:, 0]
    if pt == "LAST":
        idx = torch.clamp(lengths - 1, min=0).long()
        return x[torch.arange(x.shape[0], device=x.device), idx]
    raise ValueError(f"unknown pool_type {pool_type!r}")


def _segment(x, ids, n, kind):
    """jax.ops.segment_{sum,max,min} over the first axis."""
    ids = ids.long()
    shape = (n,) + tuple(x.shape[1:])
    if kind == "sum":
        return torch.zeros(shape, dtype=x.dtype, device=x.device).index_add(
            0, ids, x)
    fill = float("-inf") if kind == "amax" else float("inf")
    if not x.is_floating_point():
        info = torch.iinfo(x.dtype)
        fill = info.min if kind == "amax" else info.max
    base = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    idx = ids.reshape((-1,) + (1,) * (x.ndim - 1)).expand(x.shape)
    return base.scatter_reduce(0, idx, x, kind)


@register_op
def segment_pool(x, segment_ids, pooltype="SUM", num_segments=None):
    """Segment reduce over the first axis."""
    n = int(num_segments) if num_segments is not None \
        else int(segment_ids.max()) + 1
    pt = pooltype.upper()
    if pt == "SUM":
        return _segment(x, segment_ids, n, "sum")
    if pt in ("MEAN", "AVERAGE"):
        s = _segment(x, segment_ids, n, "sum")
        c = _segment(torch.ones_like(x), segment_ids, n, "sum")
        return s / torch.clamp(c, min=1)
    if pt == "MAX":
        return _segment(x, segment_ids, n, "amax")
    if pt == "MIN":
        return _segment(x, segment_ids, n, "amin")
    raise ValueError(f"unknown pooltype {pooltype!r}")


def _message(x_src, y_edge, op):
    if op == "ADD":
        return x_src + y_edge
    if op == "MUL":
        return x_src * y_edge
    raise ValueError(f"unknown message_op {op!r}")


@register_op
def send_u_recv(x, src_index, dst_index, reduce_op="SUM", out_size=None):
    """Graph gather-scatter: message x[src], reduced at dst."""
    n = int(out_size) if out_size else x.shape[0]
    msg = x[src_index.long()]
    op = reduce_op.upper()
    if op == "SUM":
        return _segment(msg, dst_index, n, "sum")
    if op == "MEAN":
        s = _segment(msg, dst_index, n, "sum")
        c = _segment(torch.ones(msg.shape[0], 1, device=x.device),
                     dst_index, n, "sum")
        return s / torch.clamp(c, min=1)
    if op == "MAX":
        return _segment(msg, dst_index, n, "amax")
    if op == "MIN":
        return _segment(msg, dst_index, n, "amin")
    raise ValueError(f"unknown reduce_op {reduce_op!r}")


@register_op
def send_ue_recv(x, y, src_index, dst_index, message_op="ADD",
                 reduce_op="SUM", out_size=None):
    n = int(out_size) if out_size else x.shape[0]
    msg = _message(x[src_index.long()], y, message_op.upper())
    return send_u_recv._kernel(msg, torch.arange(msg.shape[0],
                                                 device=x.device),
                               dst_index, reduce_op, n)


@register_op
def send_uv(x, y, src_index, dst_index, message_op="ADD"):
    return _message(x[src_index.long()], y[dst_index.long()],
                    message_op.upper())


# ---------------------------------------------------------------------------
# sampling (the port's generators: the values are not the reference's)
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def top_p_sampling(x, ps, threshold=None, seed=0):
    """Nucleus sampling -> (scores, ids): renormalise the smallest prefix
    of the sorted probabilities that reaches mass p, draw from it."""
    sorted_p, sorted_i = torch.sort(x, dim=-1, descending=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = cum - sorted_p < ps[..., None]
    probs = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    probs = probs / probs.sum(-1, keepdim=True)
    flat = probs.reshape(-1, probs.shape[-1])
    choice = torch.multinomial(flat, 1, generator=rng.seed_or_next(
        seed, x.device)).reshape(probs.shape[:-1] + (1,))
    return (torch.gather(sorted_p, -1, choice),
            torch.gather(sorted_i, -1, choice).long())


@register_op(nondiff=True)
def truncated_gaussian_random(shape, mean=0.0, std=1.0, seed=0,
                              a=-2.0, b=2.0, dtype="float32"):
    dev = device()
    z = torch.empty([int(s) for s in shape], dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, a, b,
                                generator=rng.seed_or_next(seed, dev))
    return (mean + std * z).to(td(dtype))


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws (Marsaglia and Tsang; alpha < 1 boosted by
    u^(1/alpha))."""
    a = alpha.to(torch.float32)
    boost = a < 1
    a1 = torch.where(boost, a + 1, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a1)
    todo = torch.ones_like(a1, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a1.shape, generator=gen, device=a1.device)
        u = torch.rand(a1.shape, generator=gen, device=a1.device)
        v = (1 + c * z) ** 3
        ok = (z > -1.0 / c) & (torch.log(u) < 0.5 * z * z + d - d * v
                                + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a1.shape, generator=gen, device=a1.device)
    out = torch.where(boost, out * u ** (1.0 / a), out)
    return out.to(alpha.dtype)


@register_op(nondiff=True)
def standard_gamma(x, seed=0):
    return _gamma(x, rng.seed_or_next(seed, x.device))


@register_op(nondiff=True)
def binomial(count, prob, seed=0):
    count, prob = torch.broadcast_tensors(count, prob)
    return torch.binomial(count.to(torch.float32), prob.to(torch.float32),
                          generator=rng.seed_or_next(seed, count.device)
                          ).long()
