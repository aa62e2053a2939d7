"""Op tail 4: the phi names registered over capabilities of other
modules, and the small remaining kernels — port of
`paddle_tpu/ops/kernels/tail_alias.py`.

- **Phi-name registrations**: `viterbi_decode`, the fft family and
  `stft` / `frame` / `overlap_add` over `torch.fft`,
  `cross_entropy_with_softmax`, `pool2d`, `sync_batch_norm_` (world
  size 1: the local statistics are the global ones) and the dense
  attention entries `flash_attn` (:147), `flash_attn_qkvpacked` (:169)
  and `memory_efficient_attention` (:179).
- **Small kernels**: the AMP loss-scaling ops, `merged_adam_` /
  `merged_momentum_` (the port's optimizers' update rules), the MoE
  routing helpers, the view ops, recsys `cvm`, image IO.

Routing of the attention entries is the reference's, by argument: a
mask, dropout > 0 or a bias takes the plain SDPA (`_sdpa_btHD`, the
reference's `_xla_sdpa_btHD` :121); everything else runs kernel A1
forward and, under autograd, A2 backward (`ops/cuda/flash_attention.py`
`flash_attention`, the registered torch op, with `[B, T, H, D]`
transposed to the kernel's `[B, H, T, hd]`). Where the reference falls
back to XLA for a geometry its tiling does not take, the port raises:
A1/A2 take float32 or bfloat16 with head_dim a multiple of 8 up to 128
and whole GQA groups (`supported()`); float16 or another geometry is an
error, on the card and on the CPU alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core import dtype as dtype_mod
from ...core import rng
from ..cuda import flash_attention as FA
from ..dispatch import OPS, register_op
from .nn_ops import _pool

# ---------------------------------------------------------------------------
# phi-name registrations
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True):
    """Batched Viterbi decode: (scores [B], paths [B, L] int64). With
    include_bos_eos_tag, tag N-2 is BOS and N-1 is EOS. Steps past a
    row's length carry its state through unchanged."""
    B, L, N = potentials.shape
    trans = transition_params
    alpha = potentials[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + trans[N - 2][None, :]
    lengths = lengths.reshape(-1)
    ident = torch.arange(N, device=potentials.device)[None, :].expand(B, N)
    history = []
    for t in range(1, L):
        scores = alpha[:, :, None] + trans[None, :, :]
        best, arg = scores.max(dim=1)
        active = (t < lengths)[:, None]
        alpha = torch.where(active, best + potentials[:, t], alpha)
        history.append(torch.where(active, arg, ident))
    if include_bos_eos_tag:
        alpha = alpha + trans[:, N - 1][None, :]
    score, tag = alpha.max(dim=-1)
    path = [tag]
    for hist in reversed(history):
        tag = hist.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    return score, torch.stack(path[::-1], dim=1).long()


@register_op
def fft_c2c(x, axes=(-1,), normalization="backward", forward=True):
    fn = torch.fft.fftn if forward else torch.fft.ifftn
    return fn(x, dim=tuple(axes), norm=normalization or "backward")


@register_op
def fft_r2c(x, axes=(-1,), normalization="backward", forward=True,
            onesided=True):
    if onesided:
        return torch.fft.rfftn(x, dim=tuple(axes),
                               norm=normalization or "backward")
    return torch.fft.fftn(x.to(torch.complex64), dim=tuple(axes),
                          norm=normalization or "backward")


@register_op
def fft_c2r(x, axes=(-1,), normalization="backward", forward=False,
            last_dim_size=0):
    n = last_dim_size or None
    return torch.fft.irfftn(x, s=None if n is None else [n], dim=tuple(axes),
                            norm=normalization or "backward")


def _frames(a, frame_length, hop_length):
    """[..., n] -> [..., frame_length, num_frames]."""
    num = 1 + (a.shape[-1] - frame_length) // hop_length
    idx = (torch.arange(frame_length, device=a.device)[:, None]
           + hop_length * torch.arange(num, device=a.device)[None, :])
    return a[..., idx]


@register_op
def stft(x, window, n_fft, hop_length, normalized=False, onesided=True):
    """Centered (reflect-padded) STFT over the last axis:
    [..., n_fft // 2 + 1 or n_fft, num_frames], complex."""
    w = (torch.ones(n_fft, dtype=x.dtype, device=x.device)
         if window is None else window)
    pad = n_fft // 2
    lead = x.shape[:-1]
    a = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    a = a.reshape(lead + (a.shape[-1],))
    frames = _frames(a, n_fft, hop_length) * w[:, None]
    spec = (torch.fft.rfft(frames, dim=-2) if onesided
            else torch.fft.fft(frames, dim=-2))
    if normalized:
        spec = spec / math.sqrt(n_fft)
    return spec


@register_op
def frame(x, frame_length, hop_length, axis=-1):
    return _frames(x, frame_length, hop_length)


@register_op
def overlap_add(x, hop_length, axis=-1):
    fl, num = x.shape[-2], x.shape[-1]
    out = x.new_zeros(x.shape[:-2] + (fl + hop_length * (num - 1),))
    for f in range(num):
        s = f * hop_length
        out = out.index_add(-1, torch.arange(s, s + fl, device=x.device),
                            x[..., f])
    return out


@register_op
def cross_entropy_with_softmax(logits, label, soft_label=False,
                               use_softmax=True, numeric_stable_mode=True,
                               ignore_index=-100, axis=-1):
    """use_softmax=False: the input already holds probabilities, and the
    loss is -sum(label * log(p)) with no second normalisation."""
    if use_softmax:
        return OPS["softmax_with_cross_entropy"]._kernel(
            logits, label, soft_label=soft_label, axis=axis,
            ignore_index=ignore_index)
    logp = torch.log(torch.clamp(logits, min=1e-12))
    if soft_label:
        return -torch.sum(label * logp, dim=axis, keepdim=True)
    lab = label.long()
    picked = torch.gather(logp, axis, lab)
    return torch.where(lab != ignore_index, -picked,
                       torch.zeros_like(picked))


def _sdpa_btHD(q, k, v, attn_mask, causal, scale=None, dropout_p=0.0):
    """[B, T, H, D] attention on the plain path (the reference's
    `_xla_sdpa_btHD`): additive -1e9 causal mask, the caller's additive
    mask, softmax, dropout on the probabilities."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    T, S = qt.shape[2], kt.shape[2]
    m = None
    if causal:
        tril = torch.ones((T, S), dtype=torch.bool, device=q.device).tril()
        m = torch.where(tril, 0.0, -1e9).to(q.dtype)
    if attn_mask is not None:
        m = attn_mask if m is None else m + attn_mask
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhtd,bhsd->bhts", qt, kt) * s
    if m is not None:
        logits = logits + m
    probs = torch.softmax(logits, -1)
    if dropout_p > 0.0:
        gen = rng.seed_or_next(0, q.device)
        keep = torch.rand(probs.shape, generator=gen,
                          device=q.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.einsum("bhts,bhsd->bhtd", probs, vt).transpose(1, 2)


def _flash(q, k, v, causal):
    """A1 (A2 under autograd) on [B, T, H, D]; raises outside its limits."""
    B, T, H, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or not FA.supported(H, k.shape[2], D):
        raise ValueError(
            f"flash_attn: kernels A1/A2 take float32 or bfloat16 with "
            f"head_dim a multiple of 8 up to 128 and whole GQA groups; got "
            f"{q.dtype}, H={H}, KV={k.shape[2]}, head_dim={D} (pass an "
            f"attn_mask to take the plain attention instead)")
    return FA.flash_attention(q, k, v, causal=bool(causal))


@register_op
def flash_attn(q, k, v, fixed_seed_offset=None, attn_mask=None,
               dropout=0.0, causal=False, return_softmax=False):
    """phi flash_attn on [B, T, H, D]: A1/A2 unless a mask or dropout
    asks for the plain SDPA."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn return_softmax=True: the softmax matrix is never "
            "materialized by the flash kernel")
    if dropout > 0.0:
        return _sdpa_btHD(q, k, v, attn_mask, causal, dropout_p=dropout)
    if attn_mask is not None:
        return _sdpa_btHD(q, k, v, attn_mask, causal)
    return _flash(q, k, v, causal)


@register_op
def flash_attn_qkvpacked(qkv, fixed_seed_offset=None, attn_mask=None,
                         dropout=0.0, causal=False, return_softmax=False):
    """phi flash_attn_qkvpacked: qkv [B, T, 3, H, D]."""
    return flash_attn._kernel(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              fixed_seed_offset, attn_mask, dropout, causal,
                              return_softmax)


@register_op
def memory_efficient_attention(query, key, value, bias=None,
                               cu_seqlens_q=None, cu_seqlens_k=None,
                               causal=False, dropout_p=0.0, scale=None):
    """phi memory_efficient_attention: A1/A2 when the scale and dropout
    are the defaults and there is no bias, else the plain SDPA with the
    caller's scale and dropout."""
    if scale is None and dropout_p == 0.0:
        return flash_attn._kernel(query, key, value, None, bias, 0.0,
                                  causal, False)
    return _sdpa_btHD(query, key, value, bias, causal, scale=scale,
                      dropout_p=dropout_p)


@register_op
def pool2d(x, kernel_size, strides=None, paddings=0, ceil_mode=False,
           exclusive=True, data_format="NCHW", pooling_type="max",
           global_pooling=False, adaptive=False, padding_algorithm="EXPLICIT"):
    """phi pool2d, the generic pooling entry."""
    ch_last = data_format == "NHWC"
    if adaptive:
        name = ("adaptive_max_pool2d" if pooling_type == "max"
                else "adaptive_avg_pool2d")
        return OPS[name]._kernel(x, kernel_size, data_format=data_format)
    ones = torch.ones_like(x, dtype=torch.float32)
    if padding_algorithm == "VALID":
        paddings = 0
    elif padding_algorithm == "SAME":
        # pre-pad so every output keeps ceil(in / stride) positions
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        st = k if strides is None else (
            (strides,) * 2 if isinstance(strides, int) else tuple(strides))
        cfg = [0, 0] * x.dim()
        for i in range(2):
            ax = (1 if ch_last else 2) + i
            out_s = -(-x.shape[ax] // st[i])
            total = max((out_s - 1) * st[i] + k[i] - x.shape[ax], 0)
            j = 2 * (x.dim() - 1 - ax)
            cfg[j], cfg[j + 1] = total // 2, total - total // 2
        fill = float("-inf") if pooling_type == "max" else 0.0
        ones = F.pad(ones, cfg, value=0.0)
        x = F.pad(x.float(), cfg, value=fill)
        paddings = 0
    if global_pooling:
        spatial = x.shape[1:3] if ch_last else x.shape[2:4]
        kernel_size, strides, paddings = tuple(spatial), (1, 1), 0
    if pooling_type == "max":
        return _pool(x, kernel_size, strides, paddings, data_format, "max",
                     2, ceil_mode)
    s = _pool(x, kernel_size, strides, paddings, data_format, "sum", 2,
              ceil_mode)
    cnt = _pool(ones, kernel_size, strides, paddings, data_format, "sum", 2,
                ceil_mode)
    if not exclusive:
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        cnt = torch.full_like(cnt, float(np.prod(k)))
    return (s / torch.clamp(cnt, min=1.0)).to(x.dtype)


@register_op
def sync_batch_norm_(x, mean, variance, scale, bias, is_test=False,
                     momentum=0.9, epsilon=1e-5, data_format="NCHW",
                     use_global_stats=False, trainable_statistics=False):
    """phi sync_batch_norm_ at world size 1: batch norm over the whole
    batch; returns (out, new running mean, new running variance)."""
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    shape = [1] * x.dim()
    shape[ch_axis] = -1
    if is_test or use_global_stats:
        mu, var = mean, variance
    else:
        mu = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
    out = ((x - mu.reshape(shape)) / torch.sqrt(var.reshape(shape) + epsilon)
           * scale.reshape(shape) + bias.reshape(shape))
    new_mean = momentum * mean + (1 - momentum) * mu
    new_var = momentum * variance + (1 - momentum) * var
    return out, new_mean, new_var


# ---------------------------------------------------------------------------
# AMP loss-scaling ops
# ---------------------------------------------------------------------------


def _as_list(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


@register_op(nondiff=True)
def check_finite_and_unscale_(xs, scale):
    """(the gradients divided by scale, whether any was not finite)."""
    grads = _as_list(xs)
    found = torch.zeros((), dtype=torch.bool, device=grads[0].device)
    outs = []
    for g in grads:
        found = found | ~torch.isfinite(g).all()
        outs.append(g / scale)
    return outs, found


@register_op(nondiff=True)
def update_loss_scaling_(xs, found_infinite, prev_loss_scaling,
                         in_good_steps, in_bad_steps,
                         incr_every_n_steps=1000,
                         decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                         decr_ratio=0.5, stop_update=False):
    """The dynamic loss-scale state machine: (the gradients, zeroed on a
    non-finite step; the new scale; good and bad step counts, int32)."""
    found = torch.as_tensor(found_infinite, dtype=torch.bool)
    zero = torch.zeros_like(torch.as_tensor(in_good_steps))
    good = torch.where(found, zero, in_good_steps + 1)
    bad = torch.where(found, in_bad_steps + 1, zero)
    grow = good >= incr_every_n_steps
    shrink = bad >= decr_every_n_nan_or_inf
    scale = torch.where(shrink, prev_loss_scaling * decr_ratio,
                        torch.where(grow, prev_loss_scaling * incr_ratio,
                                    prev_loss_scaling))
    scale = torch.clamp(scale, min=1.0)
    good = torch.where(grow, zero, good)
    bad = torch.where(shrink, zero, bad)
    outs = [torch.where(found, torch.zeros_like(g), g) for g in _as_list(xs)]
    return outs, scale, good.to(torch.int32), bad.to(torch.int32)


def _adam(p, g, lr, m1, m2, b1p, b2p, beta1, beta2, eps):
    m1 = beta1 * m1 + (1 - beta1) * g
    m2 = beta2 * m2 + (1 - beta2) * g * g
    b1p = b1p * beta1
    b2p = b2p * beta2
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    return p - lr_t * m1 / (torch.sqrt(m2) + eps), m1, m2, b1p, b2p


@register_op(name="merged_adam_", nondiff=True)
def merged_adam_(params, grads, learning_rate, moments1, moments2,
                 beta1_pows, beta2_pows, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
    """Adam over lists: (params, moments1, moments2, beta1_pows,
    beta2_pows), each a list."""
    outs = [_adam(p, g, learning_rate, m1, m2, b1, b2, beta1, beta2,
                  epsilon)
            for p, g, m1, m2, b1, b2 in zip(params, grads, moments1,
                                            moments2, beta1_pows,
                                            beta2_pows)]
    return tuple(list(t) for t in zip(*outs))


@register_op(name="merged_momentum_", nondiff=True)
def merged_momentum_(params, grads, velocitys, learning_rate, mu=0.9,
                     use_nesterov=False):
    """Momentum over lists: (params, velocities)."""
    outs = []
    for p, g, v in zip(params, grads, velocitys):
        v = mu * v + g
        step = g + mu * v if use_nesterov else v
        outs.append((p - learning_rate * step, v))
    return tuple(list(t) for t in zip(*outs))


# ---------------------------------------------------------------------------
# MoE auxiliary ops
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def number_count(numbers, upper_range):
    """Histogram of expert ids over [0, upper_range), int64."""
    ids = numbers.reshape(-1).long()
    ids = ids[(ids >= 0) & (ids < int(upper_range))]
    return torch.bincount(ids, minlength=int(upper_range))


@register_op(nondiff=True)
def limit_by_capacity(expert_count, capacity, n_worker=1):
    cap = torch.as_tensor(capacity, device=expert_count.device)
    return torch.minimum(expert_count, cap.to(expert_count.dtype))


@register_op(nondiff=True)
def assign_pos(x, cum_count, eff_num_len=None):
    """Token index of every expert-sorted slot (a stable sort by id)."""
    return torch.sort(x.int(), stable=True).indices.long()


@register_op(nondiff=True)
def prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker=1):
    """Tokens past their expert's capacity (in token order) get id -1."""
    ids = gate_idx.int()
    order = torch.sort(ids, stable=True).indices
    sorted_ids = ids[order]
    seq = torch.arange(ids.shape[0], device=ids.device)
    new_run = torch.ones_like(sorted_ids, dtype=torch.bool)
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(new_run, seq, 0), 0).values
    ranks = torch.empty_like(seq)
    ranks[order] = seq - run_start
    cap = expert_count[torch.clamp(ids, 0, expert_count.shape[0] - 1).long()]
    return torch.where(ranks < cap, gate_idx, torch.full_like(gate_idx, -1))


@register_op(nondiff=True)
def random_routing(topk_idx, topk_value, prob):
    """Drop a second-choice expert where prob >= 2 * its gate value."""
    keep = prob < (2.0 * topk_value)
    return torch.where(keep, topk_idx, torch.full_like(topk_idx, -1))


# ---------------------------------------------------------------------------
# views / misc small kernels
# ---------------------------------------------------------------------------


@register_op
def view_shape(input, dims):
    return input.reshape(tuple(dims))


@register_op(nondiff=True)
def view_dtype(input, dtype):
    """Bit reinterpretation, with the reference's shape rule: a narrower
    type adds a trailing axis of the size ratio, a wider one removes a
    trailing axis of that size."""
    to = dtype_mod.to_torch(dtype)
    src, dst = input.element_size(), torch.empty((), dtype=to).element_size()
    x = input.contiguous()
    if dst < src:
        return x.view(to).reshape(tuple(x.shape) + (src // dst,))
    if dst > src:
        if x.shape[-1] != dst // src:
            raise ValueError(f"view_dtype: the last axis must be "
                             f"{dst // src}, got {x.shape[-1]}")
        return x.view(to).reshape(tuple(x.shape[:-1]))
    return x.view(to)


@register_op
def view_slice(input, begin_idx, end_idx):
    return input[begin_idx:end_idx]


@register_op(nondiff=True)
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


@register_op
def multiplex(inputs, index):
    """out[i] = inputs[index[i]][i]."""
    stacked = torch.stack(list(inputs))               # [K, N, ...]
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(idx.shape[0], device=idx.device)]


@register_op
def bilinear(x, y, weight, bias=None):
    """out[b, k] = x[b] @ W[k] @ y[b] (+ bias)."""
    out = torch.einsum("bi,kij,bj->bk", x, weight, y)
    return out if bias is None else out + bias


@register_op
def affine_channel(x, scale, bias, data_format="NCHW"):
    shape = [1, -1] + [1] * (x.dim() - 2) if data_format == "NCHW" \
        else [1] * (x.dim() - 1) + [-1]
    return x * scale.reshape(shape) + bias.reshape(shape)


@register_op
def add_position_encoding(x, alpha=1.0, beta=1.0):
    """Sinusoidal position encoding added to [B, T, D]."""
    B, T, D = x.shape
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / D)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
    return alpha * x + beta * pe[None, :, :D]


@register_op
def box_clip(input, im_info):
    """Clip boxes to the image (im_info [B, 3]: h, w, scale)."""
    h = im_info[:, 0] / im_info[:, 2] - 1.0
    w = im_info[:, 1] / im_info[:, 2] - 1.0
    if input.dim() == 2:
        hh, ww = h[0], w[0]
        zero = torch.zeros((), dtype=input.dtype, device=input.device)
        return torch.stack([torch.clamp(input[:, 0], zero, ww),
                            torch.clamp(input[:, 1], zero, hh),
                            torch.clamp(input[:, 2], zero, ww),
                            torch.clamp(input[:, 3], zero, hh)], dim=-1)
    lo = torch.zeros_like(input[..., 0])
    return torch.stack([torch.clamp(input[..., 0], lo, w[:, None]),
                        torch.clamp(input[..., 1], lo, h[:, None]),
                        torch.clamp(input[..., 2], lo, w[:, None]),
                        torch.clamp(input[..., 3], lo, h[:, None])], dim=-1)


@register_op(nondiff=True)
def cvm(x, cvm_input, use_cvm=True):
    """Keep, or strip, the two leading show/click columns."""
    return x if use_cvm else x[:, 2:]


@register_op(nondiff=True)
def shuffle_batch(x, seed=0):
    gen = rng.seed_or_next(seed, x.device)
    perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
    return x[perm], perm.long()


@register_op(nondiff=True)
def reduce_as(x, target):
    """x summed down to target's (broadcastable) shape."""
    extra = x.dim() - target.dim()
    out = x.sum(dim=tuple(range(extra))) if extra else x
    axes = tuple(i for i, (a, b) in enumerate(zip(out.shape, target.shape))
                 if a != b and b == 1)
    return out.sum(dim=axes, keepdim=True) if axes else out


@register_op(nondiff=True)
def gaussian_inplace(x, mean=0.0, std=1.0, seed=0):
    gen = rng.seed_or_next(seed, x.device)
    return mean + std * torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                    device=x.device)


@register_op(nondiff=True)
def uniform_inplace(x, min=-1.0, max=1.0, seed=0, diag_num=0, diag_step=0,
                    diag_val=1.0):
    gen = rng.seed_or_next(seed, x.device)
    u = torch.rand(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return min + (max - min) * u


# ---------------------------------------------------------------------------
# image IO (host ops)
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def read_file(filename):
    """The file's bytes as a uint8 tensor."""
    with open(filename, "rb") as f:
        return torch.frombuffer(bytearray(f.read()), dtype=torch.uint8)


@register_op(nondiff=True)
def decode_jpeg(x, mode="unchanged"):
    """uint8 bytes -> [C, H, W] uint8, through PIL on the host."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(x.cpu().numpy().tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode in ("rgb", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(x.device)
