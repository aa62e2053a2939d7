"""Op tail 8 — port of `paddle_tpu/ops/kernels/tail_r5b.py`.

The QDQ pair `quantize_linear` / `dequantize_linear`, `anchor_generator`,
the FlowNet `correlation`, `batch_fc`, `hash` (the reference's
multiply-shift family on uint64, here on int64 with the same bits:
products wrap alike, the shifts are logical and the modulus is taken
unsigned), `nce` (negatives from the port's generators), and the
dequantized-embedding ops `dequantize_log` / `lookup_table_dequant`.
"""
from __future__ import annotations

import math

import torch

from ...core import rng
from ..dispatch import register_op

# ---------------------------------------------------------------------------
# QDQ pair
# ---------------------------------------------------------------------------


def _per_channel(scale, x, quant_axis):
    if scale.ndim == 0 or scale.numel() == 1:
        return scale.reshape(())
    shape = [1] * x.ndim
    shape[quant_axis] = scale.shape[0]
    return scale.reshape(shape)


@register_op
def quantize_linear(x, scale, zero_point=None, in_accum=None, in_state=None,
                    quant_axis=0, bit_length=8, qmin=-128, qmax=127,
                    round_type=0, is_test=True, only_observer=False):
    """round(x / scale + zp) clipped to [qmin, qmax], in x's dtype; round
    type 0 ties to even, 1 away from zero; the rounding passes the
    gradient straight through."""
    if only_observer:
        return x.clone()
    s = _per_channel(scale, x, int(quant_axis))
    zp = 0.0 if zero_point is None else _per_channel(zero_point, x,
                                                     int(quant_axis))
    q = x / s + zp
    r = torch.round(q) if int(round_type) == 0 \
        else torch.sign(q) * torch.floor(q.abs() + 0.5)
    q = q + (r - q).detach()
    return torch.clamp(q, qmin, qmax).to(x.dtype)


@register_op
def dequantize_linear(x, scale, zero_point=None, in_accum=None,
                      in_state=None, quant_axis=0, bit_length=8, qmin=-128,
                      qmax=127, round_type=0, is_test=True,
                      only_observer=False):
    """(x - zp) * scale."""
    if only_observer:
        return x.clone()
    s = _per_channel(scale, x, int(quant_axis))
    zp = 0.0 if zero_point is None else _per_channel(zero_point, x,
                                                     int(quant_axis))
    return (x.to(torch.float32) - zp) * s


# ---------------------------------------------------------------------------
# anchor_generator
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def anchor_generator(input, anchor_sizes=(), aspect_ratios=(),
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5):
    """Anchors [H, W, A, 4] and their variances, A = len(ratios) *
    len(sizes)."""
    h, w = int(input.shape[2]), int(input.shape[3])
    dev = input.device
    sw, sh = float(stride[0]), float(stride[1])
    boxes = []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            base_w = round(math.sqrt(sw * sh / ar))
            base_h = round(base_w * ar)
            boxes.append(((size / sw) * base_w, (size / sh) * base_h))
    xc = torch.arange(w, dtype=torch.float32, device=dev) * sw \
        + offset * (sw - 1)
    yc = torch.arange(h, dtype=torch.float32, device=dev) * sh \
        + offset * (sh - 1)
    yg, xg = torch.meshgrid(yc, xc, indexing="ij")
    anchors = torch.stack([torch.stack([
        xg - 0.5 * (aw - 1), yg - 0.5 * (ah - 1),
        xg + 0.5 * (aw - 1), yg + 0.5 * (ah - 1)], dim=-1)
        for aw, ah in boxes], dim=2)
    var = torch.tensor(list(variances), dtype=torch.float32,
                       device=dev).expand(anchors.shape).contiguous()
    return anchors, var


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------


@register_op
def correlation(input1, input2, pad_size, kernel_size, max_displacement,
                stride1, stride2, corr_type_multiply=1):
    """FlowNet correlation: the channel and window mean of input1 times
    input2 shifted, one output channel a displacement of the
    (2*max_disp/stride2+1)^2 grid."""
    c = input1.shape[1]
    kr = (kernel_size - 1) // 2
    drad = max_displacement // stride2
    pad = int(pad_size)
    x1 = torch.nn.functional.pad(input1.to(torch.float32), (pad,) * 4)
    x2 = torch.nn.functional.pad(input2.to(torch.float32), (pad,) * 4)
    ph, pw = x1.shape[2], x1.shape[3]
    border = max_displacement + kr
    out_h = (ph - 2 * border + stride1 - 1) // stride1
    out_w = (pw - 2 * border + stride1 - 1) // stride1
    nelems = kernel_size * kernel_size * c

    def win(x, dh, dw):
        h0 = max_displacement + dh
        w0 = max_displacement + dw
        return x[:, :, h0:h0 + (out_h - 1) * stride1 + 1:stride1,
                 w0:w0 + (out_w - 1) * stride1 + 1:stride1]

    chans = []
    for tj in range(-drad, drad + 1):
        for ti in range(-drad, drad + 1):
            acc = 0.0
            for j in range(-kr, kr + 1):
                for i in range(-kr, kr + 1):
                    acc = acc + (win(x1, j, i) * win(
                        x2, tj * stride2 + j, ti * stride2 + i)).sum(1)
            chans.append(acc / nelems)
    return torch.stack(chans, dim=1).to(input1.dtype)


# ---------------------------------------------------------------------------
# batch_fc / hash / nce
# ---------------------------------------------------------------------------


@register_op
def batch_fc(input, w, bias=None):
    """input [S, B, I] @ w [S, I, O] (+ bias [S, 1, O])."""
    out = torch.einsum("sbi,sio->sbo", input, w)
    return out if bias is None else out + bias


def _i64(c):
    """The int64 with the bits of the uint64 constant c."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(h, s):
    """Logical right shift of int64 bits."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def _umod(h, m):
    """(h read as uint64) mod m."""
    r = torch.remainder(h, m)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % m, m), r)


@register_op(nondiff=True)
def hash(x, num_hash=1, mod_by=100000, runtime_shape=True):
    """Bucketed id hashing: ids [N, k] -> [N, num_hash, 1] buckets in
    [0, mod_by), the reference's multiply-shift family bit for bit."""
    ids = x.long().reshape(x.shape[0], -1)
    key = ids[:, 0]
    for c in range(1, ids.shape[1]):
        key = key * 1000003 + ids[:, c]
    outs = []
    for k in range(int(num_hash)):
        h = key * _i64(0x9E3779B97F4A7C15 + 2 * k + 1)
        h = h ^ _shr(h, 29)
        h = h * _i64(0xBF58476D1CE4E5B9)
        h = h ^ _shr(h, 32)
        outs.append(_umod(h, int(mod_by)))
    return torch.stack(outs, dim=1)[..., None]


@register_op
def nce(input, label, weight, bias=None, sample_weight=None,
        custom_dist_probs=None, custom_dist_alias=None,
        custom_dist_alias_probs=None, num_total_classes=None,
        custom_neg_classes=(), num_neg_samples=10, sampler=0, seed=0,
        is_sparse=False, remote_prefetch=False, is_test=False):
    """Noise-contrastive estimation: the true classes and k sampled
    negatives scored as independent logistic classifiers with the
    k * p(class) correction. sampler 0 uniform, 1 log-uniform. -> (cost
    [B, 1], sample_logits [B, T+k], sample_labels)."""
    dev = input.device
    x = input.to(torch.float32)
    lab = label.reshape(input.shape[0], -1).long()
    bsz, t = lab.shape
    c = int(num_total_classes)
    k = int(num_neg_samples)
    gen = rng.seed_or_next(int(seed), dev)
    logc = math.log(float(c + 1))
    if int(sampler) == 1:
        u = torch.rand(bsz, k, generator=gen, device=dev)
        negs = torch.clamp((torch.exp(u * logc) - 1.0).long(), 0, c - 1)
        p_neg = torch.log((negs + 2.0) / (negs + 1.0)) / logc
        p_true = torch.log((lab + 2.0) / (lab + 1.0)) / logc
    else:
        negs = torch.randint(0, c, (bsz, k), generator=gen, device=dev)
        p_neg = torch.full((bsz, k), 1.0 / c, device=dev)
        p_true = torch.full((bsz, t), 1.0 / c, device=dev)
    samples = torch.cat([lab, negs], dim=1)
    logits = torch.einsum("bd,bsd->bs", x, weight.to(torch.float32)[samples])
    if bias is not None:
        logits = logits + bias.to(torch.float32)[samples]
    o = torch.exp(logits)
    b1 = k * torch.cat([p_true, p_neg], dim=1)
    cost = (-torch.log(o[:, :t] / (o[:, :t] + b1[:, :t]) + 1e-20)).sum(1) \
        + (-torch.log(b1[:, t:] / (o[:, t:] + b1[:, t:]) + 1e-20)).sum(1)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1).to(torch.float32)
    return cost[:, None], logits, samples


# ---------------------------------------------------------------------------
# dequantized-embedding ops
# ---------------------------------------------------------------------------


@register_op
def dequantize_log(x, dict):
    """code >= 0 reads dict[code]; code < 0 reads -dict[code + 128]."""
    codes = x.long()
    n = dict.shape[0]
    pos = dict[codes.clamp(0, n - 1)]
    neg = -dict[(codes + 128).clamp(0, n - 1)]
    return torch.where(codes < 0, neg, pos)


@register_op
def lookup_table_dequant(w, ids, padding_idx=-1):
    """Each row holds [min, max] then float32 slots each packing 4 uint8
    codes; value = (max - min) / 256 * code + min. Out-of-range and
    padding ids give zero rows."""
    idx = ids.long()
    if idx.ndim and idx.shape[-1] == 1:
        idx = idx[..., 0]
    rows = w.to(torch.float32)[idx.clamp(0, w.shape[0] - 1)]
    lo, hi = rows[..., 0:1], rows[..., 1:2]
    packed = rows[..., 2:].contiguous()
    codes = packed.view(torch.uint8).reshape(*packed.shape[:-1],
                                             packed.shape[-1] * 4)
    out = (hi - lo) / 256.0 * codes.to(torch.float32) + lo
    invalid = (idx < 0) | (idx >= w.shape[0])
    if int(padding_idx) >= 0:
        invalid = invalid | (idx == int(padding_idx))
    return torch.where(invalid[..., None], torch.zeros((), dtype=out.dtype,
                                                       device=out.device),
                       out)
