"""Op tail 7 — port of `paddle_tpu/ops/kernels/tail_r5.py`.

The phi-name `batch_norm`, `fused_moe` (dense top-k mixture of experts
with a one-hot combine), `flashmask_attention` and `sparse_attention`
(their masks as additive biases over plain attention), the strided
family (`as_strided` a gather from the flat buffer), the legacy
`multiclass_nms` over `multiclass_nms3`, the legacy `elementwise_*`
ops with their axis alignment, `cross_entropy` / `cross_entropy2` on
probabilities, `lookup_table` and `c_embedding` (the port's own copy of
the masked-window lookup `_c_lookup_table`; no collective), `c_split`,
and the aliases.

Over `distributed.collective`: `p_send`, `p_recv`, `p_send_array`,
`p_recv_array` (point to point on `ring_id`'s group, global peer
ranks), `barrier` and `c_softmax_with_cross_entropy` (vocabulary-
parallel over `ring_id`'s group when `nranks` is above one).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core import rng
from ..dispatch import register_op
from ._util import device, td

# ---------------------------------------------------------------------------
# batch_norm (phi name)
# ---------------------------------------------------------------------------


def _bn_axes_shape(x, data_format):
    if data_format in ("NCHW", "NCL", "NCDHW") and x.ndim > 2:
        return (0,) + tuple(range(2, x.ndim)), (1, -1) + (1,) * (x.ndim - 2)
    return tuple(range(x.ndim - 1)), (1,) * (x.ndim - 1) + (-1,)


@register_op
def batch_norm(x, mean, variance, scale=None, bias=None, is_test=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=False, trainable_statistics=False):
    """phi batch_norm: (out, mean_out, variance_out, saved_mean,
    saved_inv_std, reserve_space); reserve_space is empty."""
    axes, shape = _bn_axes_shape(x, data_format)
    use_running = (bool(is_test) and not trainable_statistics) \
        or bool(use_global_stats)
    batch_mean = x.mean(dim=axes)
    batch_var = x.var(dim=axes, unbiased=False)
    norm_mean = mean if use_running else batch_mean
    norm_var = variance if use_running else batch_var
    out = (x - norm_mean.reshape(shape)) * torch.rsqrt(
        norm_var.reshape(shape) + epsilon)
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if use_running:
        mean_out, variance_out = mean, variance
    else:
        mean_out = momentum * mean + (1.0 - momentum) * batch_mean
        variance_out = momentum * variance + (1.0 - momentum) * batch_var
    return (out, mean_out, variance_out, batch_mean,
            torch.rsqrt(batch_var + epsilon),
            torch.zeros(0, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# fused_moe
# ---------------------------------------------------------------------------


@register_op
def fused_moe(x, gate_weight, ffn1_weight, ffn1_scale=None, ffn1_bias=None,
              ffn2_weight=None, ffn2_scale=None, ffn2_bias=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True):
    """Dense top-k mixture-of-experts FFN. x [..., D]; gate_weight [D, E];
    ffn1_weight [E, D, I or 2I]; ffn2_weight [E, I, D]. SwiGLU when ffn1's
    last dim is twice ffn2's contraction dim, GELU otherwise; weight-only
    scales multiply back onto the integer weights."""
    if ffn2_weight is None:
        raise ValueError("fused_moe requires ffn2_weight")
    orig_shape = x.shape
    h = x.reshape(-1, orig_shape[-1])
    w1, w2 = ffn1_weight, ffn2_weight
    if ffn1_scale is not None:
        w1 = w1.to(h.dtype) * ffn1_scale[..., None, :]
    if ffn2_scale is not None:
        w2 = w2.to(h.dtype) * ffn2_scale[..., None, :]
    probs = torch.softmax((h @ gate_weight.to(h.dtype)).to(torch.float32),
                          dim=-1)
    top_p, top_e = torch.topk(probs, int(moe_topk), dim=-1)
    if norm_topk_prob:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    num_e = gate_weight.shape[-1]
    combine = (F.one_hot(top_e, num_e).to(torch.float32)
               * top_p[..., None]).sum(1)
    up = torch.einsum("td,edi->tei", h, w1.to(h.dtype))
    if ffn1_bias is not None:
        up = up + ffn1_bias.to(h.dtype)[None]
    if up.shape[-1] == 2 * w2.shape[1]:
        gate_part, lin_part = up.chunk(2, dim=-1)
        act = F.silu(gate_part) * lin_part
    else:
        act = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    down = torch.einsum("tei,eid->ted", act, w2.to(h.dtype))
    if ffn2_bias is not None:
        down = down + ffn2_bias.to(h.dtype)[None]
    out = torch.einsum("ted,te->td", down, combine.to(h.dtype))
    return out.reshape(orig_shape)


# ---------------------------------------------------------------------------
# flashmask_attention / sparse_attention
# ---------------------------------------------------------------------------


def _flashmask_bias(srowidx, sq, sk, causal, dtype):
    """FlashMask start/end row indices [B, Hk, Sk, C] as an additive bias
    [B, Hk, Sq, Sk]: the lower-left triangle is i > j, the upper-right
    i < j; the diagonal is never masked here."""
    c = srowidx.shape[-1]
    dev = srowidx.device
    i = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(sk, device=dev)[None, :]
    lower, upper = i > j, i < j
    s = srowidx.long()

    def col(idx):
        return s[..., idx][:, :, None, :]

    if causal:
        if c == 1:
            masked = lower & (i >= col(0))
        elif c == 2:
            masked = lower & (i >= col(0)) & (i < col(1))
        else:
            raise ValueError(f"causal flashmask expects C in {{1,2}}, got {c}")
    else:
        if c == 2:
            masked = (lower & (i >= col(0))) | (upper & (i < col(1)))
        elif c == 4:
            masked = ((lower & (i >= col(0)) & (i < col(1)))
                      | (upper & (i >= col(2)) & (i < col(3))))
        else:
            raise ValueError(
                f"bidirectional flashmask expects C in {{2,4}}, got {c}")
    return torch.where(masked, torch.tensor(torch.finfo(dtype).min,
                                            dtype=dtype, device=dev),
                       torch.zeros((), dtype=dtype, device=dev))


@register_op
def flashmask_attention(q, k, v, startend_row_indices,
                        fixed_seed_offset=None, dropout=0.0, causal=False,
                        return_softmax=False, is_test=False, rng_name=""):
    """FlashMask attention: q/k/v [B, S, H, D] (GQA), startend_row_indices
    [B, Hk|1, Sk, {1,2,4}]. -> (out, softmax or empty, softmax_lse,
    seed_offset)."""
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    f32 = torch.float32
    qt = q.transpose(1, 2).to(f32)
    kt = k.transpose(1, 2).to(f32)
    vt = v.transpose(1, 2).to(f32)
    if hk != hq:
        kt = kt.repeat_interleave(hq // hk, dim=1)
        vt = vt.repeat_interleave(hq // hk, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) / np.sqrt(hd)
    bias = _flashmask_bias(startend_row_indices, sq, sk, causal,
                           scores.dtype)
    bh = bias.shape[1]
    if bh not in (1, hk, hq):
        raise ValueError(
            f"startend_row_indices head dim must be 1 or {hk}, got {bh}")
    if bh not in (1, hq):
        bias = bias.repeat_interleave(hq // bh, dim=1)
    scores = scores + bias
    if causal:
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        scores = torch.where(cm, scores, torch.tensor(
            torch.finfo(scores.dtype).min, device=q.device))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt).transpose(1, 2).to(
        q.dtype)
    softmax = probs.to(q.dtype) if return_softmax else torch.zeros(
        0, dtype=q.dtype, device=q.device)
    return out, softmax, lse, torch.zeros(2, dtype=torch.int64,
                                          device=q.device)


@register_op
def sparse_attention(q, k, v, offset, columns, key_padding_mask=None,
                     attn_mask=None):
    """CSR-pattern attention: q/k/v [B, H, M, D], offset [B, H, M+1],
    columns [B, H, nnz]; only the pattern's positions take part. ->
    (out, scaled scores at the nnz positions, probabilities there)."""
    b, h, m, d = q.shape
    nnz = columns.shape[-1]
    dev = q.device
    f32 = torch.float32
    scores = torch.einsum("bhmd,bhnd->bhmn", q.to(f32), k.to(f32)) \
        / np.sqrt(d)
    pos = torch.arange(nnz, device=dev).expand(b, h, nnz).contiguous()
    rows = torch.searchsorted(offset.to(torch.int64).contiguous(), pos,
                              right=True) - 1
    cols = columns.long()
    bidx = torch.arange(b, device=dev)[:, None, None]
    hidx = torch.arange(h, device=dev)[None, :, None]
    allowed = torch.zeros(b, h, m, m, dtype=torch.bool, device=dev)
    allowed[bidx, hidx, rows, cols] = True
    if key_padding_mask is not None:
        scores = scores + key_padding_mask.to(f32)[:, None, None, :]
    if attn_mask is not None:
        scores = scores + attn_mask.to(f32)
    scores = torch.where(allowed, scores,
                         torch.tensor(torch.finfo(f32).min, device=dev))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhmn,bhnd->bhmd", probs, v.to(f32))
    return (out.to(q.dtype), scores[bidx, hidx, rows, cols].to(q.dtype),
            probs[bidx, hidx, rows, cols].to(q.dtype))


# ---------------------------------------------------------------------------
# strided family
# ---------------------------------------------------------------------------


@register_op
def as_strided(input, dims=(), stride=(), offset=0):
    """Read the flat buffer with explicit dims / strides / offset (element
    units), as a gather (its backward is the scatter-add)."""
    dims = tuple(int(s) for s in dims)
    stride = tuple(int(s) for s in stride)
    if len(dims) != len(stride):
        raise ValueError("as_strided: dims and stride must have equal rank")
    idx = torch.tensor(int(offset), dtype=torch.long, device=input.device)
    for axis, (n, st) in enumerate(zip(dims, stride)):
        shape = [1] * len(dims)
        shape[axis] = n
        idx = idx + (torch.arange(n, device=input.device) * st).reshape(shape)
    return input.reshape(-1)[idx]


@register_op
def index_select_strided(x, index, axis=0):
    """Pick one index along axis, dropping the axis."""
    return x.select(int(axis), int(index))


_LAYOUTS = {1: "NHWC", 2: "NCHW"}      # phi::DataLayout values


@register_op
def transfer_layout(x, src_layout=-1, dst_layout=-1):
    """Permute a 4-D tensor between NCHW and NHWC; unknown layouts copy."""
    src = _LAYOUTS.get(int(src_layout))
    dst = _LAYOUTS.get(int(dst_layout))
    if src is None or dst is None or src == dst or x.ndim != 4:
        return x.clone()
    if src == "NCHW":
        return x.permute(0, 2, 3, 1)
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# point to point, barrier, the vocabulary-parallel loss
# ---------------------------------------------------------------------------


def _ring(ring_id, device_type):
    from .tail_collective import ring_group
    return ring_group(ring_id, device_type)


def _coll():
    from ...distributed import collective as C
    return C


@register_op(nondiff=True)
def p_send(x, ring_id=0, peer=0, dynamic_shape=False):
    """PIR p_send (legacy/static_ops.yaml:633): send x to global rank
    `peer` over `ring_id`'s group; returns an empty tensor."""
    _coll().send(x, dst=int(peer), group=_ring(ring_id, x.device.type))
    return x.new_zeros((0,), dtype=torch.float32)


def _recv_device(ring_id):
    g = _ring(ring_id, device().type)
    if g.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device()), g
    return torch.device("cpu"), g


@register_op(nondiff=True)
def p_recv(ring_id=0, peer=0, dtype="float32", dynamic_shape=False,
           out_shape=None):
    """PIR p_recv (legacy/static_ops.yaml:610): receive a tensor of
    `out_shape` and `dtype` from global rank `peer`, on the group's
    device."""
    dev, g = _recv_device(ring_id)
    t = torch.zeros(tuple(int(v) for v in (out_shape or ())),
                    dtype=td(dtype), device=dev)
    _coll().recv(t, src=int(peer), group=g)
    return t


@register_op(nondiff=True)
def p_send_array(x, ring_id=0, peer=0):
    """PIR p_send_array (static_ops.yaml): p_send of one array."""
    return p_send._kernel(x, ring_id=ring_id, peer=peer)


@register_op(nondiff=True)
def p_recv_array(ring_id=0, peer=0, dtype="float32", out_shape=()):
    """PIR p_recv_array (static_ops.yaml:622): a static-shape receive."""
    return p_recv._kernel(ring_id=ring_id, peer=peer, dtype=dtype,
                          out_shape=out_shape)


@register_op(nondiff=True)
def barrier(x=None, ring_id=0):
    """The legacy barrier op: every rank of the group arrives."""
    dev = x.device.type if isinstance(x, torch.Tensor) else device().type
    g = _ring(ring_id, dev)
    _coll().barrier(group=g)
    if x is not None:
        return x
    return torch.zeros((1,), dtype=torch.int32,
                       device=_recv_device(ring_id)[0])


@register_op
def c_softmax_with_cross_entropy(logits, label, ignore_index=-100,
                                 ring_id=0, rank=0, nranks=1):
    """Vocabulary-parallel softmax cross entropy: (softmax, loss [..., 1]).
    With nranks above one, logits are this rank's vocabulary block [...,
    V/nranks] of `ring_id`'s group (block `rank`): the max, the sum of
    exponentials and the target's logit are all-reduced over the group
    (the mp reduction), the softmax is this block's of the whole
    vocabulary's, and the gradient of the block is its softmax less the
    target's one-hot, as Paddle's kernel gives it. Labels equal to
    `ignore_index` give loss 0."""
    y = label[..., 0] if label.dim() == logits.dim() else label
    y = y.long()
    vloc = logits.shape[-1]
    if int(nranks) <= 1:
        shifted = logits - logits.detach().amax(dim=-1, keepdim=True)
        lse = shifted.exp().sum(dim=-1).log()
        true = shifted.gather(-1, y.clamp(0, vloc - 1)[..., None])[..., 0]
        loss = torch.where(y == int(ignore_index), 0.0, lse - true)
        return torch.softmax(logits, dim=-1), loss[..., None]
    g = _ring(ring_id, logits.device.type)
    C = _coll()
    local = y - int(rank) * vloc
    ok = (local >= 0) & (local < vloc)
    onehot = F.one_hot(local.clamp(0, vloc - 1), vloc).to(logits.dtype) \
        * ok[..., None]
    with torch.no_grad():
        x = logits.detach()
        gmax = x.amax(dim=-1)
        C.all_reduce(gmax, op="max", group=g)
        ex = (x - gmax[..., None]).exp()
        sumexp = ex.sum(dim=-1)
        C.all_reduce(sumexp, group=g)
        true = ((x - gmax[..., None]) * onehot).sum(dim=-1)
        C.all_reduce(true, group=g)
        softmax = ex / sumexp[..., None]
        value = sumexp.log() - true
    # the value of the loss, with d loss / d logits = softmax - onehot
    lin = ((softmax - onehot) * logits).sum(dim=-1)
    loss = value + lin - lin.detach()
    loss = torch.where(y == int(ignore_index), 0.0, loss)
    return softmax, loss[..., None]


# ---------------------------------------------------------------------------
# multiclass_nms v1 and compat aliases
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=1000,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0):
    """Legacy multiclass_nms: Out [N, 6] only; background class 0."""
    from .vision_ops import multiclass_nms3

    out, _index, _num = multiclass_nms3._kernel(
        bboxes, scores, None, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=nms_threshold, normalized=normalized,
        nms_eta=nms_eta, background_label=background_label)
    return out


@register_op
def cross_entropy(x, label, soft_label=False, ignore_index=-100):
    """Legacy cross_entropy: x is a probability distribution. [N, 1]."""
    logp = torch.log(torch.clamp(x, 1e-12, 1.0))
    if soft_label:
        return -(label.to(x.dtype) * logp).sum(-1, keepdim=True)
    lab = label.reshape(-1).long()
    loss = -torch.gather(logp, -1, lab[:, None].clamp(min=0))
    return torch.where((lab == ignore_index)[:, None], torch.zeros_like(loss),
                       loss)


@register_op
def tril_triu(x, diagonal=0, lower=True):
    return torch.tril(x, int(diagonal)) if lower \
        else torch.triu(x, int(diagonal))


@register_op
def add_n(inputs):
    out = inputs[0]
    for a in inputs[1:]:
        out = out + a
    return out


@register_op
def grad_add(x, y):
    return x + y


@register_op(nondiff=True)
def assign_value(shape=(), dtype="float32", values=()):
    t = td(dtype)
    arr = np.asarray(list(values)).reshape(tuple(int(s) for s in shape))
    return torch.as_tensor(arr, device=device()).to(t)


def _c_lookup_table(table, index, start_index=0, vocab_size=-1):
    """Vocabulary-window lookup: ids outside [start_index, start_index +
    rows) give zero rows."""
    vloc = table.shape[0]
    local = index - start_index
    ok = (local >= 0) & (local < vloc)
    emb = table[torch.clamp(local, 0, vloc - 1)]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=table.dtype,
                                                       device=table.device))


@register_op
def c_embedding(weight, x, start_index=0, vocab_size=-1):
    """Vocabulary-sharded embedding on one shard: ids outside this
    shard's window give zero rows."""
    return _c_lookup_table(weight, x.long(), int(start_index),
                           int(vocab_size))


@register_op
def c_split(x, rank=0, nranks=1, ring_id=0, use_calc_stream=False,
            use_model_parallel=True):
    """This rank's shard of the last axis."""
    n = x.shape[-1]
    if n % int(nranks):
        raise ValueError(f"c_split: last dim {n} not divisible by {nranks}")
    step = n // int(nranks)
    return x[..., int(rank) * step:(int(rank) + 1) * step]


def _legacy_align(x, y, axis):
    """Align y's dims from `axis` of x (axis -1: numpy's trailing rule)."""
    if axis == -1 or y.ndim in (0, x.ndim):
        return y
    a = int(axis)
    return y.reshape((1,) * a + tuple(y.shape) + (1,) * (x.ndim - a - y.ndim))


@register_op
def elementwise_max(x, y, axis=-1):
    return torch.maximum(x, _legacy_align(x, y, axis))


@register_op
def elementwise_min(x, y, axis=-1):
    return torch.minimum(x, _legacy_align(x, y, axis))


@register_op
def elementwise_mod(x, y, axis=-1):
    """Remainder with the divisor's sign."""
    return torch.remainder(x, _legacy_align(x, y, axis))


@register_op
def elementwise_floordiv(x, y, axis=-1):
    return torch.floor_divide(x, _legacy_align(x, y, axis))


@register_op
def elementwise_pow(x, y, axis=-1):
    return torch.pow(x, _legacy_align(x, y, axis))


@register_op
def expand_as_v2(x, y=None, target_shape=None):
    shape = tuple(target_shape) if target_shape is not None else y.shape
    return torch.broadcast_to(x, shape)


@register_op(nondiff=True)
def gaussian_random(shape=(), mean=0.0, std=1.0, seed=0, dtype="float32"):
    from .random import gaussian

    return gaussian._kernel(shape=shape, mean=mean, std=std, seed=seed,
                            dtype=dtype)


@register_op
def lookup_table(w, ids, padding_idx=-1, start_index=0):
    """Legacy lookup_table: ids carry a trailing singleton dim; padding_idx
    and out-of-window ids give zero rows."""
    idx = ids.long()
    if idx.ndim and idx.shape[-1] == 1:
        idx = idx[..., 0]
    out = _c_lookup_table(w, idx, start_index=int(start_index))
    if int(padding_idx) >= 0:
        out = torch.where((idx == int(padding_idx))[..., None],
                          torch.zeros((), dtype=w.dtype, device=w.device),
                          out)
    return out


@register_op
def cross_entropy2(x, label, ignore_index=-100):
    """Legacy cross_entropy2 on probabilities: (out, x_shape, match_x)."""
    lab = label.reshape(-1).long()
    match_x = torch.gather(x, -1, lab[:, None].clamp(min=0))
    out = -torch.log(torch.clamp(match_x, 1e-12, 1.0))
    out = torch.where((lab == ignore_index)[:, None], torch.zeros_like(out),
                      out)
    return out, torch.tensor(list(x.shape), dtype=torch.int64,
                             device=x.device), match_x


@register_op
def dropout_nd(x, p=0.5, axis=None, seed=0, is_test=False,
               mode="upscale_in_train"):
    """Dropout whose mask varies only along the named axes. -> (out,
    uint8 mask)."""
    if is_test or p == 0.0:
        return x, torch.ones_like(x, dtype=torch.uint8)
    if axis is None:
        mask_shape = tuple(x.shape)
    else:
        named = {int(a) % x.ndim for a in
                 (axis if isinstance(axis, (list, tuple)) else [axis])}
        mask_shape = tuple(s if i in named else 1
                           for i, s in enumerate(x.shape))
    keep = torch.rand(mask_shape, generator=rng.seed_or_next(seed, x.device),
                      device=x.device) < 1.0 - p
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    out = torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return out, torch.broadcast_to(keep, x.shape).to(torch.uint8)
