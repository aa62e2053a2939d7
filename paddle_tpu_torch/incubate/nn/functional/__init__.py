"""paddle.incubate.nn.functional of the port: the fused ops.

Counterpart of `paddle_tpu/incubate/nn/functional/__init__.py`:
`fused_rms_norm` (:23), `swiglu` (:39), `fused_rotary_position_embedding`
(:48), `fused_bias_dropout_residual_layer_norm` (:102), `fused_moe`
(:124), `fused_attention` (:211), `fused_feedforward` (:270),
`fused_linear` / `fused_matmul_bias` (:312) and `fused_linear_activation`
(:334) are ported here as plain functions on torch.Tensors (f32 math
where the reference upcasts), with the serving names (:199-207) from
`ops/kernels/serving_attention.py` and `fused_dropout_add` from
`ops/kernels/fused_ops.py`. They are compositions in the reference
too: no Pallas kernel serves them there. The dropout masks come from
torch's generators, so they differ from the reference's draws.
"""
from __future__ import annotations

import math

import torch

from ....ops.dispatch import call_op, register_op
from ....ops.kernels import serving_attention as _serving

__all__ = ["fused_rms_norm", "swiglu", "fused_rotary_position_embedding",
           "fused_linear", "fused_matmul_bias", "flash_attn_unpadded",
           "block_multihead_attention", "masked_multihead_attention",
           "fused_multi_transformer",
           "variable_length_memory_efficient_attention",
           "fused_bias_dropout_residual_layer_norm", "fused_attention",
           "fused_multi_head_attention", "fused_feedforward", "fused_moe",
           "fused_linear_activation", "fused_dropout_add"]


@register_op(name="fused_rms_norm")
def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMS norm over axes [begin_norm_axis, ndim) in f32, scaled by
    norm_weight (plus norm_bias), in x's type."""
    bna = (begin_norm_axis if begin_norm_axis >= 0
           else x.dim() + begin_norm_axis)
    axes = tuple(range(bna, x.dim()))
    x32 = x.float()
    var = x32.square().mean(dim=axes, keepdim=True)
    out = x32 * torch.rsqrt(var + epsilon)
    out = out * norm_weight.float().reshape(x.shape[bna:])
    if norm_bias is not None:
        out = out + norm_bias.float().reshape(x.shape[bna:])
    return out.to(x.dtype)


@register_op(name="swiglu")
def swiglu(x, y=None):
    """silu(x) * y; y defaults to the second half of x's last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return torch.nn.functional.silu(x) * y


@register_op(name="fused_rotary_position_embedding")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """Rotary embedding of q (and k, v) [B, T, H, D]. Without sin/cos the
    table is built over T positions from rotary_emb_base; sin/cos may be
    given as [1, T, 1, D] (interleaved pairs) or [T, D/2]. position_ids
    [B, T] picks each token's row of the table. Returns q's rotation, or
    a tuple of those given when k or v is."""
    def rope(x):
        if x is None:
            return None
        B, T, H, D = x.shape
        if sin is None or cos is None:
            pos = torch.arange(T, device=x.device)
            inv = 1.0 / (rotary_emb_base ** (torch.arange(
                0, D, 2, dtype=torch.float32, device=x.device) / D))
            ang = pos[:, None] * inv[None, :]
            s, c = torch.sin(ang), torch.cos(ang)
        else:
            s = torch.as_tensor(sin, device=x.device).squeeze()
            c = torch.as_tensor(cos, device=x.device).squeeze()
            if s.shape[-1] == D:
                s, c = s[..., ::2], c[..., ::2]
            if s.dim() == 1:
                s, c = s[None, :], c[None, :]
        if position_ids is not None:
            pid = torch.as_tensor(position_ids, device=x.device).long()
            s, c = s[pid][:, :, None, :], c[pid][:, :, None, :]
        else:
            s, c = s[None, :, None, :], c[None, :, None, :]
        if use_neox_rotary_style:
            x1, x2 = x[..., :D // 2], x[..., D // 2:]
            return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                             dim=-1).to(x.dtype)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           dim=-1).reshape(x.shape).to(x.dtype)

    outs = tuple(rope(t) for t in (q, k, v))
    if k is None and v is None:
        return outs[0]
    return tuple(o for o in outs if o is not None)


@register_op(name="fused_linear")
def fused_linear(x, weight, bias=None, transpose_weight=False):
    """x @ weight (+ bias); weight transposed first when asked."""
    w = weight.t() if transpose_weight else weight
    out = x @ w
    if bias is not None:
        out = out + bias
    return out


fused_matmul_bias = fused_linear
flash_attn_unpadded = _serving.flash_attn_unpadded
block_multihead_attention = _serving.block_multihead_attention_


def _ln(y, scale, bias, eps):
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, correction=0, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def _dropout(y, rate, training, gen=None):
    """Upscale-in-train dropout; the global stream unless `gen`."""
    if not training or rate <= 0.0:
        return y
    from ....core import rng

    gen = gen or rng.next_generator(y.device)
    keep = 1.0 - rate
    mask = torch.rand(y.shape, generator=gen, device=y.device) < keep
    return y * mask / keep


@register_op(name="fused_bias_dropout_residual_layer_norm")
def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.0, ln_epsilon=1e-5,
                                           training=False, seed=0):
    """LN(dropout(x + bias) + residual) (`:102`); a nonzero seed fixes the
    dropout mask."""
    y = x if bias is None else x + bias
    gen = None
    if seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    y = _dropout(y, dropout_rate, training, gen) + residual
    return _ln(y, ln_scale, ln_bias, ln_epsilon).to(x.dtype)


@register_op(name="fused_attention")
def fused_attention(x, qkv_weight, linear_weight, qkv_bias=None,
                    linear_bias=None, pre_ln_scale=None, pre_ln_bias=None,
                    ln_scale=None, ln_bias=None, num_heads=None,
                    pre_layer_norm=False, epsilon=1e-5,
                    attn_dropout_rate=0.0, dropout_rate=0.0, attn_mask=None,
                    training=False):
    """The fused attention block (`:211`): optional pre-LN, the packed
    QKV projection (qkv_weight [3, H, Dh, D]), attention (a bool mask
    keeps where True, another is added), the out projection
    (linear_weight [D, D]), dropout, the residual, optional post-LN."""
    residual = x
    h = _ln(x, pre_ln_scale, pre_ln_bias, epsilon) if pre_layer_norm else x
    _, H, Dh, _ = qkv_weight.shape
    qkv = torch.einsum("btd,khnd->btkhn", h, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias[None, None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B, T, H, Dh]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(Dh))
    if attn_mask is not None:
        logits = (torch.where(attn_mask, logits, -1e30)
                  if attn_mask.dtype == torch.bool else logits + attn_mask)
    probs = _dropout(torch.softmax(logits, -1), attn_dropout_rate, training)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
        h.shape[0], h.shape[1], H * Dh)
    out = o @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    out = residual + _dropout(out, dropout_rate, training)
    if not pre_layer_norm:
        out = _ln(out, ln_scale, ln_bias, epsilon)
    return out.to(x.dtype)


_FF_ACTS = {"relu": torch.nn.functional.relu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
            "silu": torch.nn.functional.silu}


@register_op(name="fused_feedforward")
def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=False):
    """The fused FFN block (`:270`): optional pre-LN, linear1, act (relu,
    gelu in its tanh form, silu), dropout, linear2, dropout, the
    residual, optional post-LN."""
    h = _ln(x, ln1_scale, ln1_bias, ln1_epsilon) if pre_layer_norm else x
    h = h @ linear1_weight
    if linear1_bias is not None:
        h = h + linear1_bias
    h = _dropout(_FF_ACTS[activation](h), dropout1_rate, training)
    h = h @ linear2_weight
    if linear2_bias is not None:
        h = h + linear2_bias
    out = x + _dropout(h, dropout2_rate, training)
    if not pre_layer_norm:
        out = _ln(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out.to(x.dtype)


def _capacity(num_tokens: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(capacity_factor * num_tokens * top_k / num_experts)
    return max(1, min(c, num_tokens))


def _dispatch_onehots(topi, num_experts: int, capacity: int):
    """Per-k dispatch one-hots [N, E, C] of top-k routing: each token's
    slot in its expert, in token order, k by k; tokens past capacity get
    none."""
    N, K = topi.shape
    counts = torch.zeros(num_experts, dtype=torch.long, device=topi.device)
    onehots = []
    for k in range(K):
        e_idx = topi[:, k]
        mask = torch.nn.functional.one_hot(e_idx, num_experts)
        pos = torch.cumsum(mask, 0) - 1 + counts[None, :]
        counts = counts + mask.sum(0)
        p = pos.gather(1, e_idx[:, None])[:, 0]
        oh = (mask.float()[:, :, None]
              * torch.nn.functional.one_hot(
                  torch.clamp(p, 0, capacity - 1), capacity).float()[:, None])
        onehots.append(oh * (p < capacity).float()[:, None, None])
    return onehots


def _fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias,
               ffn2_bias, moe_topk, norm_topk_prob):
    B, T, D = x.shape
    N, E = B * T, gate_weight.shape[-1]
    xf = x.reshape(N, D)
    probs = torch.softmax(xf.float() @ gate_weight.float(), dim=-1)
    topv, topi = torch.topk(probs, moe_topk, dim=-1)
    if norm_topk_prob:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    ohs = _dispatch_onehots(topi, E, _capacity(N, E, moe_topk, 2.0))
    disp = sum(ohs[1:], ohs[0])
    comb = sum(oh * topv[:, k][:, None, None] for k, oh in enumerate(ohs))
    xe = torch.einsum("nd,nec->ecd", xf.float(), disp).to(x.dtype)
    h = torch.einsum("ecd,edf->ecf", xe, ffn1_weight.to(xe.dtype))
    if ffn1_bias is not None:
        h = h + ffn1_bias[:, None, :]
    if ffn1_weight.shape[-1] == 2 * ffn2_weight.shape[1]:   # packed swiglu
        g, u = h.chunk(2, dim=-1)
        h = torch.nn.functional.silu(g) * u
    else:
        h = torch.nn.functional.silu(h)
    ye = torch.einsum("ecf,efd->ecd", h, ffn2_weight.to(h.dtype))
    if ffn2_bias is not None:
        ye = ye + ffn2_bias[:, None, :]
    y = torch.einsum("ecd,nec->nd", ye.float(), comb)
    return y.reshape(B, T, D).to(x.dtype)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn2_bias=None, quant_method: str = "None", moe_topk: int = 2,
              norm_topk_prob: bool = True, group_moe: bool = False):
    """The gated MoE FFN (`:124`) with dense one-hot dispatch: x [B, T,
    D], gate_weight [D, E], ffn1_weight [E, D, 2F] (gate and up packed,
    swiglu) or [E, D, F] (silu), ffn2_weight [E, F, D]; capacity factor
    2, top-k probabilities renormalized when norm_topk_prob."""
    return call_op("fused_moe", _fused_moe,
                   (x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias,
                    ffn2_bias, int(moe_topk), bool(norm_topk_prob)), {})


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu"):
    """act(x @ y + bias) (`:334`), act an op of the registry by name."""
    from ....ops.dispatch import OPS
    from .... import tensor as _tensor_api  # noqa: F401  (registers)

    xx = x.t() if trans_x else x
    out = OPS["fused_linear"](xx, y, bias, transpose_weight=trans_y)
    if activation in (None, "", "none"):
        return out
    return OPS[activation](out)


fused_multi_head_attention = fused_attention
masked_multihead_attention = _serving.masked_multihead_attention_
fused_multi_transformer = _serving.fused_multi_transformer_
variable_length_memory_efficient_attention = (
    _serving.variable_length_memory_efficient_attention)


def __getattr__(name):
    # fused_dropout_add lives in ops/kernels/fused_ops.py, which imports
    # the nn kernels, which import this module: looked up at first use
    if name == "fused_dropout_add":
        from ....ops.kernels import fused_ops

        return fused_ops.fused_dropout_add
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
