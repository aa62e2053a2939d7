"""paddle.incubate.nn.functional of the port: the fused ops a
PaddleNLP-style LLaMA layer calls over packed variable-length sequences.

Counterpart of `paddle_tpu/incubate/nn/functional/__init__.py`:
`fused_rms_norm` (:23), `swiglu` (:39), `fused_rotary_position_embedding`
(:48) and `fused_linear` / `fused_matmul_bias` (:312) are ported here as
plain functions on torch.Tensors (f32 math where the reference upcasts);
`flash_attn_unpadded` and `block_multihead_attention` come from
`ops/kernels/serving_attention.py`. `fused_linear` is a plain product
and bias add, as in the reference: no fused kernel serves it there.
"""
from __future__ import annotations

import torch

from ....ops.dispatch import register_op
from ....ops.kernels import serving_attention as _serving

__all__ = ["fused_rms_norm", "swiglu", "fused_rotary_position_embedding",
           "fused_linear", "fused_matmul_bias", "flash_attn_unpadded",
           "block_multihead_attention"]


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
