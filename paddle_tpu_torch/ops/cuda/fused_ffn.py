"""Kernels A3, A4 and A6: the fused SwiGLU FFN, `(silu(x@w1) * (x@w3)) @ w2`,
forward and backward, and its weight-only int8 forward; kernels A8 and
A9: the GEMM epilogue `act(x @ y + bias)` and the GLU `act(u) * v`.

A3 replaces `paddle_tpu/ops/pallas/fused_ffn.py:206 _fwd` (`_fwd_kernel`
:145, `pl.pallas_call` :223), reached on the serving tick through
`fused_ffn` :406 / `apply_ffn` :482 and in the training step through
`llama.ffn`. A4 replaces `_bwd` :316 (`_dx_kernel` :258,
`_dw_kernel` :284, `_act_grads` :239; `pl.pallas_call` :333 and :368):
`fused_ffn_op`, A3 registered as a torch op whose backward is A4
(`fused_ffn_bwd_op`), is the counterpart of the reference's
`custom_vjp` (:384). A6 replaces `fused_ffn_w8` :431
(`_fwd_w8_kernel` :172, `pl.pallas_call` :470), the serving tick's FFN
on w8 weights, reached through `apply_ffn` :482. A8 replaces
`fused_gemm_epilogue` :539 (`_epilogue_kernel` :529, `pl.pallas_call`
:574) and A9 `fused_glu` :591 (`_glu_kernel` :585, `pl.pallas_call`
:611); the fused ops `gemm_epilogue` and `fused_bias_act`
(`ops/kernels/fused_ops.py`) reach them.

Bound on the H100: bytes at decode. At R = 8 rows, d = 4096, d_ff =
11008 in bf16 one layer reads 270.5 MB of weights (about 81 us at 3.35
TB/s) for 2.2 GFLOP; only prefill chunks of a few hundred rows approach
the card's ridge. At the training step's R = 4096 rows it is bound by
operations: 1.11 TFLOP, 1.12 ms at 989 TFLOP/s.

Design (`csrc/fused_ffn.cu`): the TPU kernel accumulates the
down-projection across its sequential d_ff grid axis in VMEM; GPU blocks
run in parallel and cannot, so the launch is three deterministic kernels
— gate/up writes g = silu(x@w1)*(x@w3) to a scratch [R, d_ff]; the down
projection writes per-split f32 partial sums of g@w2 (a fixed split of
d_ff, `ffn_splits`, so a decode launch still fills the card); a reduce
adds them in split order. No atomics, so a recomputed prefill gives the
same pages and tokens as the first run. In bf16 every product is a
`wgmma` on the tensor cores, from 128-byte-swizzled bf16 tiles that a
producer warpgroup streams in by TMA through a four-stage ring
(`csrc/gemm_sm90.cuh`, on the machinery of `csrc/flash_sm90.cuh`); g is
written as two bf16 planes hi + lo (the bytes of an f32 g) and the down
product walks both, so g keeps the f32 reference's precision. Tiles are
128 x 128 for R > 64 rows, 64 x 64 for decode rows, where one
zero-filled 64-row tile carries the rows. f32 (the agreement checks)
keeps CUDA-core FMA tiles and an f32 g. No cuBLAS.

A4 (`csrc/fused_ffn_bwd.cu`) is bound by operations at training rows:
at R = 4096, d = 4096, d_ff = 11008 its eight products take 2.95 TFLOP
(2.99 ms at 989 TFLOP/s in bf16). The reference recomputes u = x@w1 and
v = x@w3 inside both of its launches so [R, d_ff] never reaches HBM; a
GPU block owning a (d, d_ff) tile of dw1 would need the whole
d-contraction for u, so the launch is three kernels over scratch: one
writes du, dv and g = silu(u)*v [R, d_ff], one forms dx = du@w1ᵀ +
dv@w3ᵀ, one the three weight gradients. Every output tile is owned by
one block with its sum in a fixed order: no atomics, and the gradients
repeat exactly from run to run. In bf16 all three kernels run on the
same wgmma core: du, dv and g are bf16 hi/lo planes, walked as pairs;
xᵀ·du and gᵀ·do read both operands MN-major. The built libraries state
the product units a call issues (`fused_ffn_fwd_units`,
`fused_ffn_bwd_units`: 64³ multiply-adds, hi/lo counted), which the
measured rates divide by.

A6 (`csrc/fused_ffn_w8.cu`) keeps A3's three deterministic steps and
reads the weights as int8, half of A3's bytes: 135.3 MB a layer at
d = 4096, d_ff = 11008, a 0.040 ms bound at R = 8 rows. The
per-output-channel scales (divided by 127 once, in the wrapper) multiply
the gate and up sums before silu, as they cannot pass the nonlinearity,
and the down scale multiplies the ordered sum of the split partials
once. bf16 x runs on the wgmma core of `csrc/gemm_sm90.cuh` with the
product swapped, out^T = W^T x^T: the int8 weight tiles come in by TMA
and the consumer warpgroup widens W^T straight into the wgmma's register
A operand (exact: |q| <= 127 fits bf16's significand), with the token
rows as the wgmma's N (8 for a decode tick, tiles of 64 above,
`w8_tile`); g goes through bf16 hi/lo planes as in A3, and the down
product is split over d_ff by `w8_splits`. f32 x keeps the CUDA-core
kernels, widening 16 int8 weights a load to f32 (`splits`). No
dequantized copy of a weight ever reaches device or shared memory.

A8 (`csrc/fused_gemm_epilogue.cu`) is bound by operations at training
rows (`[4096, 4096] @ [4096, 12288]`: 412 GFLOP, 0.417 ms at 989
TFLOP/s in bf16) and by the bytes of y at decode rows. It applies bias
and activation to the f32 accumulator before its only store, so
`x @ y + bias` never reaches device memory. Three kernels, chosen before
the launch by `epilogue_path` from dtype, shape, strides and addresses:
"wgmma" for bf16 operands TMA can address (the wgmma core of
`csrc/gemm_sm90.cuh`: x K-major, y MN-major, a four-stage TMA ring,
128-row tiles, or 64 x 64 tiles three to an SM for up to 64 rows), "mma"
for other bf16 operands (mma.sync m16n8k16 on 128 x 128 tiles), "fma"
for f32 (CUDA-core FMA tiles). The reference has no backward kernel:
`FusedGemmEpilogue`'s backward is plain PyTorch (cuBLAS products),
recomputing the pre-activation in f32 when there is an activation.

A9 (`csrc/fused_glu.cu`) is bound by bytes: at 4,096 x 11,008 in bf16
it moves 271 MB (0.081 ms at 3.35 TB/s). It reads u and v as strided
rows of the one `[rows, 2f]` tensor that `fused_bias_act` splits, 16
bytes a thread, and writes `act(u) * v` once. Forward only, like the
reference; `FusedGLU`'s backward is plain PyTorch.

The reference's VMEM plans (`fused_ffn.py:100-116`, `epilogue_supported`
:513, `glu_supported` :622) do not carry over: `supported()`,
`epilogue_supported()` and `glu_supported()` state these kernels' own
limits.
"""
from __future__ import annotations

import math

import torch

from . import build
from .build import INT, LONG, PTR

__all__ = ["fused_ffn", "fused_ffn_plain", "fused_ffn_bwd",
           "fused_ffn_bwd_plain", "fused_ffn_op", "fused_ffn_bwd_op",
           "fused_ffn_w8", "fused_ffn_w8_plain", "params_kind", "apply_ffn",
           "supported", "splits", "ffn_splits", "w8_tile", "w8_splits",
           "EPILOGUE_ACTS",
           "epilogue_supported", "epilogue_path", "epilogue_tile",
           "fused_gemm_epilogue", "fused_gemm_epilogue_fwd",
           "fused_gemm_epilogue_plain", "FusedGemmEpilogue",
           "glu_supported", "fused_glu", "fused_glu_fwd", "fused_glu_plain",
           "FusedGLU", "KERNEL", "KERNEL_BWD", "KERNEL_W8",
           "KERNEL_EPILOGUE", "KERNEL_GLU"]

KERNEL = build.Kernel(
    "fused_ffn",
    {"fused_ffn_fwd": [PTR] * 7 + [INT] * 5 + [PTR],
     "fused_ffn_fwd_units": ([INT] * 3, LONG),
     "fused_ffn_fwd_smem": [INT, INT],
     "fused_ffn_maps_encoded": ([], LONG)},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:206")
KERNEL_BWD = build.Kernel(
    "fused_ffn_bwd",
    {"fused_ffn_bwd": [PTR] * 12 + [INT] * 4 + [PTR],
     "fused_ffn_bwd_units": ([INT] * 3, LONG),
     "fused_ffn_bwd_smem": [INT, INT]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:316")
KERNEL_W8 = build.Kernel(
    "fused_ffn_w8",
    {"fused_ffn_w8_fwd": [PTR] * 10 + [INT] * 5 + [PTR],
     "fused_ffn_w8_smem": [INT, INT],
     "fused_ffn_w8_tile_rows": [INT],
     "fused_ffn_w8_blocks_per_sm": [INT]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:431")
KERNEL_EPILOGUE = build.Kernel(
    "fused_gemm_epilogue",
    {"fused_gemm_epilogue": [PTR] * 4 + [INT] * 8 + [PTR],
     "fused_gemm_epilogue_smem": [INT],
     "fused_gemm_epilogue_tile_n": [INT]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:539")
KERNEL_GLU = build.Kernel(
    "fused_glu", {"fused_glu": [PTR] * 3 + [INT] * 6 + [PTR]},
    replaces="paddle_tpu/ops/pallas/fused_ffn.py:591")

_SMS = 132                  # streaming multiprocessors of an H100 SXM
_BN, _BK = 32, 64           # mirrors csrc/fused_ffn_w8.cu
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


def ffn_splits(rows: int, d: int, d_ff: int) -> int:
    """A3's split of d_ff for its down product: as many slices as keep
    every block of the launch resident at once (the bf16 kernel's tiles,
    `csrc/fused_ffn.cu`: 64 x 64 with two blocks an SM for up to 64 rows,
    128 x 128 with one above), at most one slice per 64-deep tile and 16
    in all. The f32 kernels take the same count."""
    tile, per_sm = (64, 2) if rows <= 64 else (128, 1)
    blocks = math.ceil(rows / tile) * math.ceil(d / tile)
    return max(1, min(math.ceil(d_ff / _BK), _SMS * per_sm // blocks, 16))


def w8_tile(rows: int) -> tuple:
    """(token rows, blocks an SM) of A6's bf16 tiles for `rows` rows
    (`csrc/fused_ffn_w8.cu`; `chip_smoke.py`'s build phase holds the built
    library to it): each block owns 64 weight columns and 8 token rows
    (a decode tick), four blocks an SM, or 64 rows, two an SM."""
    return (8, 4) if rows <= 8 else (64, 2)


def w8_splits(rows: int, d: int, d_ff: int,
              dtype=torch.bfloat16) -> int:
    """A6's split of d_ff for its down product. bf16 x: as many slices
    as keep every block of the launch resident at once (`w8_tile`'s
    tiles), at most one slice per 64-deep tile and 16 in all. f32 x
    keeps the CUDA-core kernels and their `splits`."""
    if dtype != torch.bfloat16:
        return splits(rows, d, d_ff)
    n, per_sm = w8_tile(rows)
    blocks = math.ceil(rows / n) * math.ceil(d / 64)
    return max(1, min(math.ceil(d_ff / _BK), _SMS * per_sm // blocks, 16))


def _tma_ready(name: str, *tensors) -> None:
    """Raise unless every tensor can be read or written by TMA: its
    address 16-byte aligned and, for a matrix, its row stride a multiple
    of 16 bytes."""
    for t in tensors:
        rows_ok = t.dim() < 2 or t.stride(-2) * t.element_size() % 16 == 0
        if t.data_ptr() % 16 or not rows_ok:
            raise ValueError(f"{name}: the kernels read and write whole 16-"
                             f"byte words; a {tuple(t.shape)} tensor at "
                             f"address {t.data_ptr():#x} with strides "
                             f"{t.stride()} is not 16-byte aligned")


def fused_ffn_plain(x, w1, w3, w2):
    """Plain PyTorch version: the three products in f32, as the TPU
    kernel upcasts its inputs; result in x's type."""
    x32 = x.float()
    g = torch.nn.functional.silu(x32 @ w1.float()) * (x32 @ w3.float())
    return (g @ w2.float()).to(x.dtype)


def _scratch(R, f, dtype, device):
    """An [R, f] intermediate of A3 or A4 in R * f * 4 bytes: f32 for
    the f32 kernels, bf16 planes hi and lo [2, R, f] for the bf16 ones."""
    if dtype == torch.bfloat16:
        return torch.empty((2, R, f), dtype=torch.bfloat16, device=device)
    return torch.empty((R, f), dtype=torch.float32, device=device)


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
    _tma_ready("fused_ffn", x2, w1, w3, w2)
    n_split = ffn_splits(R, d, f)
    g = _scratch(R, f, x.dtype, x.device)
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
    _tma_ready("fused_ffn_bwd", x, w1, w3, w2, do)
    du, dv, g = (_scratch(R, f, x.dtype, x.device) for _ in range(3))
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


# A3 and A4 as registered ops, for the train step: a selective-checkpoint
# policy (remat="dots") sees dispatcher ops only, so A3's output can be
# named and saved only once A3 is one. The serving paths call `fused_ffn`
# (through `apply_ffn`) directly.
@torch.library.custom_op(
    "paddle_tpu_torch::fused_ffn_fwd", mutates_args=(),
    schema="(Tensor x, Tensor w1, Tensor w3, Tensor w2) -> Tensor")
def fused_ffn_op(x, w1, w3, w2):
    """A3 as the op `paddle_tpu_torch::fused_ffn_fwd` over rows x [R, d]
    (see `fused_ffn`). Differentiable in x and the weights; its backward
    is A4 (`fused_ffn_bwd_op`)."""
    return fused_ffn(x, w1, w3, w2)


@fused_ffn_op.register_fake
def _(x, w1, w3, w2):
    return torch.empty_like(x)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_ffn_bwd", mutates_args=(),
    schema="(Tensor x, Tensor w1, Tensor w3, Tensor w2, Tensor do) -> "
           "(Tensor, Tensor, Tensor, Tensor)")
def fused_ffn_bwd_op(x, w1, w3, w2, do):
    """A4 as the op `paddle_tpu_torch::fused_ffn_bwd` (see
    `fused_ffn_bwd`): (dx, dw1, dw3, dw2)."""
    return fused_ffn_bwd(x, w1, w3, w2, do)


@fused_ffn_bwd_op.register_fake
def _(x, w1, w3, w2, do):
    return tuple(torch.empty_like(t) for t in (x, w1, w3, w2))


def _setup_ffn(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward_ffn(ctx, do):
    return fused_ffn_bwd_op(*ctx.saved_tensors, do)


fused_ffn_op.register_autograd(_backward_ffn, setup_context=_setup_ffn)


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
    _tma_ready("fused_ffn_w8", x2, w1_q, w3_q, w2_q, s1, s3, s2)
    n_split = w8_splits(R, d, f, x.dtype)
    g = _scratch(R, f, x.dtype, x.device)
    part = torch.empty((n_split, R, d), dtype=torch.float32, device=x.device)
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    err = KERNEL_W8.fn("fused_ffn_w8_fwd")(
        x2.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), w3_q.data_ptr(),
        s3.data_ptr(), w2_q.data_ptr(), s2.data_ptr(), g.data_ptr(),
        part.data_ptr(), out.data_ptr(), R, d, f, n_split, dtype, stream)
    KERNEL_W8.check(err)
    KERNEL_W8.count("wgmma" if x.dtype == torch.bfloat16 else "fma")
    return out.reshape(*lead, d)


def params_kind(lp):
    """Which fused FFN serves this layer's leaves: "fp" (plain weights),
    "w8" (weight-only int8 with per-channel scales) or None (w8a8 leaves,
    which carry activation scales, and fp8 leaves: no kernel serves
    them). "w8" requires int8 weights, so A6 never reads float8 bytes as
    int8."""
    names = ("w1", "w3", "w2")
    if all(n in lp for n in names):
        return "fp"
    if (all(f"{n}_q" in lp and f"{n}_s" in lp for n in names)
            and not any(f"{n}_a" in lp for n in names)
            and all(lp[f"{n}_q"].dtype == torch.int8 for n in names)):
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


# ---------------------------------------------------------------------------
# A8 and A9: the GEMM epilogue and the GLU
# ---------------------------------------------------------------------------

F = torch.nn.functional

# the reference's `_EPI_ACTS`, in order of the kernels' ACT_* codes
# (csrc/activation.cuh); jax.nn.gelu is the tanh form, torch's default
# is not
_EPI_ACTS = {
    "none": lambda t: t,
    "relu": F.relu,
    "gelu": lambda t: F.gelu(t, approximate="tanh"),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
}
EPILOGUE_ACTS = tuple(_EPI_ACTS)
_ACT_CODE = {name: i for i, name in enumerate(EPILOGUE_ACTS)}
_MAX_GRID_Y = 65535          # CUDA's limit on gridDim.y
_INT_MAX = 2 ** 31 - 1


def _vec(t, ld: int) -> int:
    """1 when rows `ld` elements apart, from t's address, start on 16-byte
    boundaries, so the kernel may read them in 16-byte words."""
    return int(t.data_ptr() % 16 == 0 and ld * t.element_size() % 16 == 0)


def epilogue_supported(m: int, k: int, n: int, activation: str,
                       dtype=torch.bfloat16) -> bool:
    """Can A8 serve `act(x @ y + bias)` for x [m, k], y [k, n]? The
    activation in its set, f32 or bf16, and m within the grid's 65,535
    rows of 64-row tiles; any m, k and n otherwise (ragged tiles are
    masked)."""
    return (activation in _ACT_CODE and dtype in build.DTYPE_CODE
            and 1 <= m <= 64 * _MAX_GRID_Y and 1 <= k <= _INT_MAX
            and 1 <= n <= _INT_MAX)


def epilogue_tile(m: int) -> tuple:
    """(rows, columns, blocks an SM) of the tile A8's wgmma kernel takes
    for m rows (`csrc/fused_gemm_epilogue.cu`; `chip_smoke.py`'s build
    phase holds the built library to it): 64 x 64 tiles three to an SM
    for decode rows, where y's bytes bound the product and every block of
    a launch should be resident at once; 128 x 256 tiles one to an SM
    above."""
    return (64, 64, 3) if m <= 64 else (128, 256, 1)


def epilogue_path(x, y) -> str:
    """The kernel A8 launches for x [m, k] and y [k, n] as the wrapper
    passes them (contiguous), from dtype, shape, strides and addresses
    alone: "wgmma" for bf16 operands TMA can address (each base 16-byte
    aligned, each row a multiple of 16 bytes), "mma" for other bf16
    operands, "fma" for f32."""
    if x.dtype != torch.bfloat16:
        return "fma"
    if all(t.data_ptr() % 16 == 0 and t.stride(0) * t.element_size() % 16
           == 0 for t in (x, y)):
        return "wgmma"
    return "mma"


def fused_gemm_epilogue_plain(x, y, bias=None, activation: str = "none"):
    """Plain PyTorch version of A8, the reference kernel's math: the
    product, bias and activation in f32, one rounding to x's type."""
    z = x.float() @ y.float()
    if bias is not None:
        z = z + bias.float()
    return _EPI_ACTS[activation](z).to(x.dtype)


def fused_gemm_epilogue_fwd(x, y, bias=None, activation: str = "none"):
    """A8's forward: x [m, k], y [k, n] of one type, bias [n] or None.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_gemm_epilogue_plain(x, y, bias, activation)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"fused_gemm_epilogue takes x [m, k] and y [k, n]; "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    m, k = x.shape
    n = y.shape[1]
    if y.dtype != x.dtype or not epilogue_supported(m, k, n, activation,
                                                    x.dtype):
        raise ValueError(f"unsupported epilogue m={m} k={k} n={n} "
                         f"act={activation!r} dtypes {x.dtype}/{y.dtype}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias must be [n] = [{n}], got {tuple(bias.shape)}")
    x, y = x.contiguous(), y.contiguous()
    b = None if bias is None else bias.float().contiguous()
    stream = build.launch_stream("fused_gemm_epilogue", x, y,
                                 *(() if b is None else (b,)))
    path = epilogue_path(x, y)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = KERNEL_EPILOGUE.fn("fused_gemm_epilogue")(
        x.data_ptr(), y.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), m, k, n, _ACT_CODE[activation], _vec(x, k),
        _vec(y, n), int(path == "wgmma"), build.DTYPE_CODE[x.dtype], stream)
    KERNEL_EPILOGUE.check(err)
    KERNEL_EPILOGUE.count(path)
    return out


def _act_grad(z, g, act: str):
    """g times the derivative of the activation at z, in f32."""
    with torch.enable_grad():
        z = z.detach().requires_grad_()
        return torch.autograd.grad(_EPI_ACTS[act](z), z, g)[0]


class FusedGemmEpilogue(torch.autograd.Function):
    """Differentiable A8. The reference has no backward kernel (XLA
    differentiates the stock composition); the backward here is plain
    PyTorch: dz = do · act'(x @ y + bias), recomputing the pre-activation
    in f32 when there is an activation, then dx = dz @ yᵀ, dy = xᵀ @ dz
    and dbias = Σ dz as cuBLAS products in the inputs' type."""

    @staticmethod
    def forward(ctx, x, y, bias, activation: str):
        ctx.save_for_backward(x, y, bias)
        ctx.activation = activation
        return fused_gemm_epilogue_fwd(x, y, bias, activation)

    @staticmethod
    def backward(ctx, do):
        x, y, bias = ctx.saved_tensors
        act = ctx.activation
        dz = do
        if act != "none":
            z = x.float() @ y.float()
            if bias is not None:
                z = z + bias.float()
            dz = _act_grad(z, do.float(), act).to(x.dtype)
        dx = dz @ y.t() if ctx.needs_input_grad[0] else None
        dy = x.t() @ dz if ctx.needs_input_grad[1] else None
        db = None
        if bias is not None and ctx.needs_input_grad[2]:
            db = dz.float().sum(0).to(bias.dtype)
        return dx, dy, db, None


def fused_gemm_epilogue(x, y, bias=None, activation: str = "none"):
    """`act(x @ y + bias)` in one launch of A8 (differentiable): x [m, k],
    y [k, n] (f32 or bf16, one type), bias [n] or None; result [m, n] in
    x's type. CPU tensors run the plain version."""
    return FusedGemmEpilogue.apply(x, y, bias, activation)


def glu_supported(rows: int, f: int, act: str, dtype=torch.bfloat16) -> bool:
    """Can A9 serve `act(u) * v` for u, v [rows, f]? The activation in its
    set, f32 or bf16, at least one element."""
    return (act in _ACT_CODE and dtype in build.DTYPE_CODE
            and 1 <= rows <= _INT_MAX and 1 <= f <= _INT_MAX)


def fused_glu_plain(u, v, act: str = "silu"):
    """Plain PyTorch version of A9: `act(u) * v` in f32, one rounding to
    u's type."""
    return (_EPI_ACTS[act](u.float()) * v.float()).to(u.dtype)


def fused_glu_fwd(u, v, act: str = "silu"):
    """A9's forward: u, v [rows, f] of one type, each row contiguous, the
    two with one row stride (the halves of one [rows, 2f] tensor, as
    views). CPU tensors run the plain version; CUDA tensors launch the
    kernel, which reads the views in place. Returns [rows, f]."""
    if u.device.type == "cpu":
        return fused_glu_plain(u, v, act)
    if u.dim() != 2 or u.shape != v.shape or v.dtype != u.dtype:
        raise ValueError(f"fused_glu takes u, v [rows, f] of one type; got "
                         f"{tuple(u.shape)} {u.dtype}, {tuple(v.shape)} "
                         f"{v.dtype}")
    rows, f = u.shape
    if not glu_supported(rows, f, act, u.dtype):
        raise ValueError(f"unsupported glu rows={rows} f={f} act={act!r} "
                         f"dtype {u.dtype}")
    if u.stride(1) != 1 or v.stride(1) != 1 or u.stride(0) != v.stride(0) \
            or u.stride(0) < f or u.stride(0) > _INT_MAX:
        raise ValueError(f"fused_glu reads rows of one stride with unit "
                         f"columns; got strides {u.stride()} {v.stride()}")
    if v.device != u.device:
        raise ValueError(f"fused_glu: u on {u.device}, v on {v.device}")
    ld = u.stride(0)
    out = torch.empty((rows, f), dtype=u.dtype, device=u.device)
    stream = build.launch_stream("fused_glu", out)
    vec = int(_vec(u, ld) and _vec(v, ld) and _vec(out, f))
    err = KERNEL_GLU.fn("fused_glu")(
        u.data_ptr(), v.data_ptr(), out.data_ptr(), rows, f, ld,
        _ACT_CODE[act], vec, build.DTYPE_CODE[u.dtype], stream)
    KERNEL_GLU.check(err)
    KERNEL_GLU.launches += 1
    return out


class FusedGLU(torch.autograd.Function):
    """Differentiable A9. Forward only in the reference; the backward is
    plain PyTorch in f32: du = g · act'(u) · v, dv = g · act(u)."""

    @staticmethod
    def forward(ctx, u, v, act: str):
        ctx.save_for_backward(u, v)
        ctx.act = act
        return fused_glu_fwd(u, v, act)

    @staticmethod
    def backward(ctx, g):
        u, v = ctx.saved_tensors
        g32, u32 = g.float(), u.float()
        du = _act_grad(u32, g32 * v.float(), ctx.act).to(u.dtype)
        dv = (g32 * _EPI_ACTS[ctx.act](u32)).to(v.dtype)
        return du, dv, None


def fused_glu(u, v, act: str = "silu"):
    """`act(u) * v` in one launch of A9 (differentiable) for u, v [rows,
    f] (see `fused_glu_fwd`); result in u's type."""
    return FusedGLU.apply(u, v, act)
