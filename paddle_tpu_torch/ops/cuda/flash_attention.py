"""Kernels A1 and A2: flash attention forward and backward.

Replaces `paddle_tpu/ops/pallas/flash_attention.py`: A1 is `_fwd` :216
(`_fwd_kernel` :153, `pl.pallas_call` :264), A2 is `_bwd` :381
(`_dq_kernel` :280 and `_dkv_kernel` :326, `pl.pallas_call` :414 and
:459). The training step reaches them through
`llama.attention`; the `torch.autograd.Function` here is
the counterpart of the reference's `custom_vjp` (:483).

Bound on the H100: operations. At B = 2, T = 2048, H = 32, hd = 128,
causal, A1 takes 68.7 GFLOP (0.070 ms at 989 TFLOP/s in bf16); A2 needs
five products per visible pair, 171.9 GFLOP (0.174 ms), and its kernels
do seven (240.6 GFLOP): each recomputes q·kᵀ and dO·vᵀ.

Design (`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`): the
TPU kernels carry the running softmax statistics and the gradient sums
across a sequential grid axis; GPU blocks run in parallel, so each block
walks its own loop instead. The forward and dq: one block per (batch,
head, 64-row q tile), looping over 64-key kv tiles up to the diagonal.
dk/dv: one block per (batch, kv head, 64-key kv tile), looping over the
G q heads of its group and the q tiles from the diagonal on. Nothing
crosses blocks — no atomics, so a recomputed forward (activation
checkpointing) gives the same output. ``delta = rowsum(dO * O)`` stays a
plain torch op before the backward launch, as the reference leaves it to
XLA. `lse` is [B, H, T] f32; the reference's 8-lane broadcast of it is a
Mosaic tiling artifact. Segment ids (varlen) wait for the
`flash_attn_unpadded` slice.

`supported()` states this kernel's own limits; the reference's
`_pick_block` rule does not carry over, and any T runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .build import FLOAT, INT, PTR

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "FlashAttention", "supported", "KERNEL_FWD", "KERNEL_BWD"]

KERNEL_FWD = build.Kernel(
    "flash_attention",
    {"flash_attention_fwd": [PTR] * 5 + [INT] * 7 + [FLOAT, INT, PTR]},
    replaces="paddle_tpu/ops/pallas/flash_attention.py:216")
KERNEL_BWD = build.Kernel(
    "flash_attention_bwd",
    {"flash_attention_bwd": [PTR] * 9 + [INT] * 7 + [FLOAT, INT, PTR]},
    replaces="paddle_tpu/ops/pallas/flash_attention.py:381")

_MAX_HEAD_DIM = 128          # mirrors kMaxHD in csrc/flash_tiles.cuh


def supported(num_heads: int, num_kv_heads: int, head_dim: int) -> bool:
    """Can the CUDA kernels serve this head geometry? GQA groups whole,
    head_dim a multiple of 8 (16-byte loads) up to 128 (the shared
    tiles); any sequence length runs — the kernels mask ragged tiles."""
    return (num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and head_dim % 8 == 0 and 8 <= head_dim <= _MAX_HEAD_DIM)


def _masked_scores(q, k, causal: bool, sm_scale: float):
    """f32 scores [B, KV, G, T, S] of q [B, H, T, hd] against k [B, KV,
    S, hd] (q head h reads kv head h // G), and the keep mask."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, T, hd)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * sm_scale
    keep = None
    if causal:
        keep = torch.ones((T, S), dtype=torch.bool,
                          device=q.device).tril()
    return s, keep


def flash_attention_fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain PyTorch version of A1 in the kernels' layout: q [B, H, T,
    hd], k/v [B, KV, S, hd] -> (o [B, H, T, hd] in q's type, lse [B, H,
    T] f32). Math in f32, as the TPU kernel upcasts its tiles."""
    B, H, T, hd = q.shape
    s, keep = _masked_scores(q, k, causal, sm_scale)
    if keep is not None:
        s = torch.where(keep, s, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(s, dim=-1)                       # [B, KV, G, T]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return (o.reshape(B, H, T, hd).to(q.dtype),
            lse.reshape(B, H, T))


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              sm_scale: float):
    """Plain PyTorch version of A2: the flash-attention-2 formulas from
    the saved lse (not autograd), in f32. Returns (dq, dk, dv) in the
    types of q, k, v."""
    B, H, T, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    s, keep = _masked_scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.reshape(B, KV, G, T)[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    do32 = do.float().reshape(B, KV, G, T, hd)
    delta = (do.float() * o.float()).sum(-1).reshape(B, KV, G, T)
    dp = torch.einsum("bkgtd,bksd->bkgts", do32, v.float())
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, k.float())
    dk = torch.einsum("bkgts,bkgtd->bksd", ds,
                      q.float().reshape(B, KV, G, T, hd))
    dv = torch.einsum("bkgts,bkgtd->bksd", p, do32)
    return (dq.reshape(B, H, T, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, causal):
    B, H, T, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"flash attention takes q [B, H, T, hd] and k/v "
                         f"[B, KV, S, hd]; got q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if not supported(H, k.shape[1], hd):
        raise ValueError(f"unsupported flash attention geometry H={H} "
                         f"KV={k.shape[1]} head_dim={hd}")
    if causal and k.shape[2] != T:
        raise ValueError(f"causal flash attention needs T == S, got {T} "
                         f"vs {k.shape[2]}")
    dtype = build.DTYPE_CODE.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, "
                         f"v of one type; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    return dtype


def flash_attention_fwd(q, k, v, causal: bool, sm_scale: float):
    """A1 in the kernels' layout (see `flash_attention_fwd_plain`). CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    dtype = _check(q, k, v, causal)
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    stream = build.launch_stream("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = KERNEL_FWD.fn("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, KV, T, S, hd, int(causal), float(sm_scale),
        dtype, stream)
    KERNEL_FWD.check(err)
    KERNEL_FWD.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        sm_scale: float):
    """A2 (see `flash_attention_bwd_plain`). CPU tensors run the plain
    version; CUDA tensors launch the kernels (dq, then dk/dv) after
    computing delta = rowsum(dO * O) in f32."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         sm_scale)
    dtype = _check(q, k, v, causal)
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != q.shape[:3]:
        raise ValueError(f"flash attention backward: do {tuple(do.shape)} "
                         f"{do.dtype} and lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    stream = build.launch_stream("flash_attention_bwd", q, k, v, do, lse,
                                 delta)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = KERNEL_BWD.fn("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, KV, T, S, hd, int(causal), float(sm_scale),
        dtype, stream)
    KERNEL_BWD.check(err)
    KERNEL_BWD.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable A1 over the kernels' layout [B, H, T, hd]: the
    forward saves (q, k, v, o, lse) and the backward is A2."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None):
    """Fused attention, differentiable. q [B, T, H, hd], k/v [B, S, KV,
    hd] -> [B, T, H, hd], the reference's layout (:502); GQA when H > KV.
    CPU tensors run the plain versions (forward and FA-2 backward); CUDA
    tensors launch A1 and, under autograd, A2 — an unsupported geometry
    raises. Segment ids are not ported yet."""
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError(
            "segment ids (varlen attention) come with the "
            "flash_attn_unpadded slice")
    hd = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, bool(causal), float(sm_scale))
    return o.transpose(1, 2)
