"""Kernels A3, A4 and A6: the fused SwiGLU FFN, `(silu(x@w1) * (x@w3)) @ w2`,
forward and backward, and its weight-only int8 forward.

A3 replaces `paddle_tpu/ops/pallas/fused_ffn.py:206 _fwd` (`_fwd_kernel`
:145, `pl.pallas_call` :223), reached on the serving tick through
`fused_ffn` :406 / `apply_ffn` :482 and in the training step through
`llama.ffn`. A4 replaces `_bwd` :316 (`_dx_kernel` :258,
`_dw_kernel` :284, `_act_grads` :239; `pl.pallas_call` :333 and :368):
`FusedFFN`, a `torch.autograd.Function` whose forward is A3 and whose
backward is A4, is the counterpart of the reference's `custom_vjp`
(:384). A6 replaces `fused_ffn_w8` :431 (`_fwd_w8_kernel` :172,
`pl.pallas_call` :470), the serving tick's FFN on w8 weights, reached
through `apply_ffn` :482. The GEMM/GLU epilogues (A8, A9) come in a
later slice.

Bound on the H100: bytes at decode. At R = 8 rows, d = 4096, d_ff =
11008 in bf16 one layer reads 270.5 MB of weights (about 81 us at 3.35
TB/s) for 2.2 GFLOP; only prefill chunks of a few hundred rows approach
the card's ridge. At the training step's R = 4096 rows it is bound by
operations: 1.11 TFLOP, 1.12 ms at 989 TFLOP/s.

Design (`csrc/fused_ffn.cu`): the TPU kernel accumulates the
down-projection across its sequential d_ff grid axis in VMEM; GPU blocks
run in parallel and cannot, so the launch is three deterministic kernels
— gate/up writes g = silu(x@w1)*(x@w3) as f32 to a scratch [R, d_ff];
the down projection writes per-split f32 partial sums of g@w2 (a fixed
split of d_ff so a decode launch still puts about four blocks on each
SM); a reduce adds them in split order. No atomics, so a recomputed
prefill gives the same pages and tokens as the first run. Tiles are
staged in shared memory and multiplied with FMAs on the CUDA cores; no
cuBLAS. The g round trip is R·d_ff·4 bytes, 0.35 MB at R = 8, nothing
beside the weights; folding the steps into one launch and tensor cores
for prefill rows are later work.

A4 (`csrc/fused_ffn_bwd.cu`) is bound by operations at training rows:
at R = 4096, d = 4096, d_ff = 11008 its eight products take 2.95 TFLOP
(2.99 ms at 989 TFLOP/s in bf16). The reference recomputes u = x@w1 and
v = x@w3 inside both of its launches so [R, d_ff] never reaches HBM; a
GPU block owning a (d, d_ff) tile of dw1 would need the whole
d-contraction for u, so the launch is three kernels over f32 scratch:
one writes du, dv and g = silu(u)*v [R, d_ff], one forms dx = du@w1ᵀ +
dv@w3ᵀ, one the three weight gradients. Every output tile is owned by
one block with its sum in a fixed order: no atomics, and the gradients
repeat exactly from run to run.

A6 (`csrc/fused_ffn_w8.cu`) keeps A3's three deterministic steps and
reads the weights as int8, half of A3's bytes: 135.3 MB a layer at
d = 4096, d_ff = 11008, a 0.040 ms bound at R = 8 rows. Sixteen int8
weights come in one 16-byte load and are widened to f32 in registers;
the per-output-channel scales (divided by 127 once, in the wrapper)
multiply the gate and up sums before silu, as they cannot pass the
nonlinearity, and the down scale multiplies the ordered sum of the
split partials once. No bf16 copy of a weight is ever made.

The reference's VMEM plan (`fused_ffn.py:100-116`) does not carry over:
`supported()` states these kernels' own limits, and any row count runs.
"""
from __future__ import annotations

import math

import torch

from . import build
from .build import INT, PTR

__all__ = ["fused_ffn", "fused_ffn_plain", "fused_ffn_bwd",
           "fused_ffn_bwd_plain", "FusedFFN", "fused_ffn_w8",
           "fused_ffn_w8_plain", "params_kind", "apply_ffn", "supported",
           "splits", "KERNEL", "KERNEL_BWD", "KERNEL_W8"]

KERNEL = build.Kernel(
    "fused_ffn",
    {"fused_ffn_fwd": [PTR] * 7 + [INT] * 5 + [PTR]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:206")
KERNEL_BWD = build.Kernel(
    "fused_ffn_bwd",
    {"fused_ffn_bwd": [PTR] * 12 + [INT] * 4 + [PTR]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:316")
KERNEL_W8 = build.Kernel(
    "fused_ffn_w8",
    {"fused_ffn_w8_fwd": [PTR] * 10 + [INT] * 5 + [PTR]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:431")

_SMS = 132                  # streaming multiprocessors of an H100 SXM
_BN, _BK = 32, 64           # mirrors csrc/fused_ffn.cu and fused_ffn_w8.cu
_QMAX = 127.0               # inference/quant/transform.py QMAX


def supported(d: int, d_ff: int, w8: bool = False) -> bool:
    """Can the CUDA kernels serve this FFN geometry? Widths must be
    multiples of 8 (16-byte loads of 8 bf16 weights), of 16 for int8
    weights (16 to a load); any row count >= 1 runs."""
    step = 16 if w8 else 8
    return d >= 8 and d_ff >= 8 and d % step == 0 and d_ff % step == 0


def splits(rows: int, d: int, d_ff: int) -> int:
    """How many d_ff slices the down projection is cut into: enough for
    about four blocks per SM, at most one slice per 64-deep tile."""
    br = 8 if rows <= 8 else 32
    blocks = math.ceil(d / _BN) * math.ceil(rows / br)
    return max(1, min(math.ceil(d_ff / _BK), math.ceil(4 * _SMS / blocks),
                      16))


def fused_ffn_plain(x, w1, w3, w2):
    """Plain PyTorch version: the three products in f32, as the TPU
    kernel upcasts its inputs; result in x's type."""
    x32 = x.float()
    g = torch.nn.functional.silu(x32 @ w1.float()) * (x32 @ w3.float())
    return (g @ w2.float()).to(x.dtype)


def _check(x, w1, w3, w2):
    """The kernels' argument rules; returns the element-type code."""
    d, f = x.shape[-1], w1.shape[-1]
    if w1.shape != (d, f) or w3.shape != (d, f) or w2.shape != (f, d):
        raise ValueError(f"FFN weights w1={tuple(w1.shape)} "
                         f"w3={tuple(w3.shape)} w2={tuple(w2.shape)} do not "
                         f"match hidden d={d}")
    if not supported(d, f):
        raise ValueError(f"unsupported FFN geometry d={d} d_ff={f}")
    dtype = build.DTYPE_CODE.get(x.dtype)
    if dtype is None or any(w.dtype != x.dtype for w in (w1, w3, w2)):
        raise ValueError(f"fused FFN takes float32 or bfloat16 x and weights "
                         f"of the same type; got {x.dtype}, {w1.dtype}")
    return dtype


def fused_ffn(x, w1, w3, w2):
    """SwiGLU FFN: x [..., d]; w1/w3 [d, d_ff]; w2 [d_ff, d] -> [..., d]
    in x.dtype. CPU tensors run the plain version; CUDA tensors launch
    the kernel (float32 or bfloat16, weights of x's type)."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, w3, w2)
    dtype = _check(x, w1, w3, w2)
    lead, d = x.shape[:-1], x.shape[-1]
    f = w1.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    R = x2.shape[0]
    if R < 1:
        return torch.empty_like(x)
    stream = build.launch_stream("fused_ffn", x2, w1, w3, w2)
    n_split = splits(R, d, f)
    g = torch.empty((R, f), dtype=torch.float32, device=x.device)
    part = torch.empty((n_split, R, d), dtype=torch.float32, device=x.device)
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    err = KERNEL.fn("fused_ffn_fwd")(
        x2.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        g.data_ptr(), part.data_ptr(), out.data_ptr(), R, d, f, n_split,
        dtype, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return out.reshape(*lead, d)


def fused_ffn_bwd_plain(x, w1, w3, w2, do):
    """Plain PyTorch version of A4: the reference's `_act_grads` math in
    f32 for x, do [R, d]. Returns (dx in x's type, dw1, dw3, dw2 in the
    weights' type)."""
    x32, do32 = x.float(), do.float()
    w1f, w3f, w2f = w1.float(), w3.float(), w2.float()
    u, v = x32 @ w1f, x32 @ w3f
    sg = torch.sigmoid(u)
    dg = do32 @ w2f.t()
    du = dg * v * (sg * (1.0 + u * (1.0 - sg)))
    dv = dg * (u * sg)
    g = (u * sg) * v
    dx = du @ w1f.t() + dv @ w3f.t()
    return (dx.to(x.dtype), (x32.t() @ du).to(w1.dtype),
            (x32.t() @ dv).to(w3.dtype), (g.t() @ do32).to(w2.dtype))


def fused_ffn_bwd(x, w1, w3, w2, do):
    """A4: the gradients of `fused_ffn` for x, do [R, d] (see
    `fused_ffn_bwd_plain`). CPU tensors run the plain version; CUDA
    tensors launch the kernels."""
    if x.device.type == "cpu":
        return fused_ffn_bwd_plain(x, w1, w3, w2, do)
    dtype = _check(x, w1, w3, w2)
    if x.dim() != 2 or do.shape != x.shape or do.dtype != x.dtype:
        raise ValueError(f"fused FFN backward takes x and do [R, d] of one "
                         f"type; got {tuple(x.shape)} {x.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    R, d = x.shape
    f = w1.shape[1]
    x, do = x.contiguous(), do.contiguous()
    stream = build.launch_stream("fused_ffn_bwd", x, w1, w3, w2, do)
    du, dv, g = (torch.empty((R, f), dtype=torch.float32, device=x.device)
                 for _ in range(3))
    dx = torch.empty_like(x)
    dw1, dw3, dw2 = (torch.empty_like(w) for w in (w1, w3, w2))
    err = KERNEL_BWD.fn("fused_ffn_bwd")(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        do.data_ptr(), du.data_ptr(), dv.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(), R, d,
        f, dtype, stream)
    KERNEL_BWD.check(err)
    KERNEL_BWD.launches += 1
    return dx, dw1, dw3, dw2


class FusedFFN(torch.autograd.Function):
    """Differentiable SwiGLU FFN over rows x [R, d]: the forward is A3,
    the backward A4 (on the CPU, their plain versions)."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2):
        ctx.save_for_backward(x, w1, w3, w2)
        return fused_ffn(x, w1, w3, w2)

    @staticmethod
    def backward(ctx, do):
        return fused_ffn_bwd(*ctx.saved_tensors, do)


def _w8_scales(w1_s, w3_s, w2_s):
    """The per-output-channel absmax scales ([1, n] or [n]) as the f32
    dequant multipliers s / 127, flat, as the reference kernel takes
    them."""
    return tuple((s.reshape(-1).float() / _QMAX).contiguous()
                 for s in (w1_s, w3_s, w2_s))


def fused_ffn_w8_plain(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s):
    """Plain PyTorch version of A6, the reference kernel's f32 math:
    u = (x@w1_q)*s1/127, v = (x@w3_q)*s3/127, g = silu(u)*v,
    out = (g@w2_q)*s2/127 in x's type."""
    s1, s3, s2 = _w8_scales(w1_s, w3_s, w2_s)
    x32 = x.float()
    u = (x32 @ w1_q.float()) * s1
    v = (x32 @ w3_q.float()) * s3
    g = torch.nn.functional.silu(u) * v
    return ((g @ w2_q.float()) * s2).to(x.dtype)


def fused_ffn_w8(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s):
    """Weight-only int8 SwiGLU FFN (forward only; quantized weights are
    served, never trained): x [..., d] f32 or bf16; w1_q/w3_q int8
    [d, d_ff], w2_q int8 [d_ff, d]; w1_s/w3_s [1, d_ff] and w2_s [1, d]
    absmax scales from `quantize_llama_params`. Returns [..., d] in x's
    type. CPU tensors run the plain version; CUDA tensors launch A6."""
    if x.device.type == "cpu":
        return fused_ffn_w8_plain(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s)
    lead, d = x.shape[:-1], x.shape[-1]
    f = w1_q.shape[-1]
    if w1_q.shape != (d, f) or w3_q.shape != (d, f) or w2_q.shape != (f, d):
        raise ValueError(f"int8 FFN weights w1={tuple(w1_q.shape)} "
                         f"w3={tuple(w3_q.shape)} w2={tuple(w2_q.shape)} do "
                         f"not match hidden d={d}")
    if any(w.dtype != torch.int8 for w in (w1_q, w3_q, w2_q)):
        raise ValueError("fused_ffn_w8 takes int8 weights")
    if (w1_s.numel(), w3_s.numel(), w2_s.numel()) != (f, f, d):
        raise ValueError("fused_ffn_w8 takes one scale per output channel")
    if not supported(d, f, w8=True):
        raise ValueError(f"unsupported int8 FFN geometry d={d} d_ff={f}")
    dtype = build.DTYPE_CODE.get(x.dtype)
    if dtype is None:
        raise ValueError(f"fused_ffn_w8 takes float32 or bfloat16 x; got "
                         f"{x.dtype}")
    x2 = x.reshape(-1, d).contiguous()
    R = x2.shape[0]
    if R < 1:
        return torch.empty_like(x)
    s1, s3, s2 = _w8_scales(w1_s, w3_s, w2_s)
    stream = build.launch_stream("fused_ffn_w8", x2, w1_q, s1, w3_q, s3,
                                 w2_q, s2)
    n_split = splits(R, d, f)
    g = torch.empty((R, f), dtype=torch.float32, device=x.device)
    part = torch.empty((n_split, R, d), dtype=torch.float32, device=x.device)
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    err = KERNEL_W8.fn("fused_ffn_w8_fwd")(
        x2.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), w3_q.data_ptr(),
        s3.data_ptr(), w2_q.data_ptr(), s2.data_ptr(), g.data_ptr(),
        part.data_ptr(), out.data_ptr(), R, d, f, n_split, dtype, stream)
    KERNEL_W8.check(err)
    KERNEL_W8.launches += 1
    return out.reshape(*lead, d)


def params_kind(lp):
    """Which fused FFN serves this layer's leaves: "fp" (plain weights),
    "w8" (weight-only int8 with per-channel scales) or None."""
    names = ("w1", "w3", "w2")
    if all(n in lp for n in names):
        return "fp"
    if (all(f"{n}_q" in lp and f"{n}_s" in lp for n in names)
            and not any(f"{n}_a" in lp for n in names)):
        return "w8"
    return None


def apply_ffn(h, lp):
    """A (possibly quantized) layer's FFN through its fused kernel: A3 on
    the fp weights cast to h's type, A6 on the int8 leaves as they are."""
    kind = params_kind(lp)
    if kind == "fp":
        return fused_ffn(h, *(lp[n].to(h.dtype) for n in ("w1", "w3", "w2")))
    if kind == "w8":
        return fused_ffn_w8(h, lp["w1_q"], lp["w1_s"], lp["w3_q"],
                            lp["w3_s"], lp["w2_q"], lp["w2_s"])
    raise ValueError("the fused FFN serves fp or weight-only int8 leaves")
