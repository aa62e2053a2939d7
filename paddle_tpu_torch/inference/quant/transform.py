"""Quantized model transform — the port of
`paddle_tpu/inference/quant/transform.py`: weight-only int8 (`w8`),
static int8 activations with int8 weights (`w8a8`) and weight-only
float8_e4m3fn (`fp8`).

``quantize_llama_params`` (reference :67) rewrites the parameter dict
the serving engine runs: every block matmul weight (wq/wk/wv/wo/w1/w3/
w2) and the lm_head become these leaves, with the reference's names and
shapes —

- ``<name>_q``  int8 weights (float8_e4m3fn in `fp8`), same
  [L, in, out] layout ([in, out] for the lm_head);
- ``<name>_s``  f32 per-output-channel absmax scales [L, 1, out]
  ([1, out] for the lm_head); they stay f32 whatever type the fp
  leaves are stored in (`models.llama.params_from_numpy` and the
  engine keep every `*_s` leaf f32);
- ``<name>_a``  f32 per-layer activation absmax [L] (an f32 scalar for
  the lm_head), from the calibration manifest — `w8a8` only.

``matmul_param(h, tree, name)`` (reference :117) is the one product the
engine calls for q/k/v/o and the lm_head, in the reference's order of
operations:

- fp leaves: ``h @ w``;
- w8: ``(h @ w_q.to(h.dtype)) * (s / 127).to(h.dtype)``;
- fp8: ``(h @ w_q.to(h.dtype)) * (s / 448).to(h.dtype)``;
- w8a8: ``xq = clip(round(h / a * 127))`` as int8, the int8 x int8 ->
  int32 product, then ``acc * ((a * s) / 127²)`` in f32, cast to h's
  type.

They are plain products outside any kernel, as the reference leaves
them to XLA: the casts of the weights are plain ops, and the int8
product is `torch._int_mm` (cuBLASLt on the card). Its int32 sums are
exact (|acc| <= K·127² < 2³¹ for any K the configs have), so a row's
result does not depend on the other rows of the call nor on the
device. On the card `_int_mm` takes more than 16 rows and widths that
are multiples of 8: fewer rows are padded with zero rows, which change
no other row's sums, and `quantize_llama_params` refuses other widths
there. Its second operand is read column-major: the w8a8 weights are
stored so (same shape and values as the reference's leaves, transposed
strides): a row-major operand is copied first (`chip_smoke.py`'s
`ENGINE_W8A8` phase times both layouts).

``ffn_param(h, lp)`` routes a layer's FFN as the reference does
(`engine.py:651-658`, `llm.py:104-108`): fp and w8 leaves through the
fused kernel (`ops/cuda/fused_ffn.py` `apply_ffn`: A3, or A6 on the
int8 leaves as they are), w8a8 and fp8 leaves, which no kernel serves,
through the plain chain ``silu(h @ w1) * (h @ w3) @ w2`` of
`matmul_param` products. The route follows from the leaves' kinds
alone.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...ops.cuda import fused_ffn as FF

__all__ = ["quantize_llama_params", "quantize_weight", "matmul_param",
           "ffn_param", "quantize_act", "int8_matmul", "fp8_dtype",
           "QUANT_MODES", "WEIGHT_NAMES", "QMAX", "FP8_MAX",
           "INT_MM_MIN_ROWS"]

QMAX = 127.0
FP8_MAX = 448.0            # float8_e4m3fn's largest finite value
QUANT_MODES = ("", "w8", "w8a8", "fp8")
WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
INT_MM_MIN_ROWS = 17       # torch._int_mm on CUDA takes more than 16 rows
_INT_MM_WIDTH = 8          # ... and widths that are multiples of 8


def fp8_dtype() -> torch.dtype:
    """The `fp8` mode's weight type."""
    return torch.float8_e4m3fn


def quantize_weight(w: torch.Tensor, in_axis: int, mode: str = "w8"):
    """(quantized weights, f32 absmax scales with keepdims along
    `in_axis`), the reference's `_quantize_stack` (:54) in f32:
    clip(round(w / s * 127)) as int8 (torch.round rounds half to even as
    jnp.round does), or in `fp8` (w / s * 448) cast to float8_e4m3fn
    (round to nearest even, as jnp's astype)."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=in_axis, keepdim=True), min=1e-8)
    if mode == "fp8":
        return (w / s * FP8_MAX).to(fp8_dtype()), s
    wq = torch.clamp(torch.round(w / s * QMAX), -QMAX, QMAX)
    return wq.to(torch.int8), s


def _quantize_stack(w: torch.Tensor, mode: str):
    """A stacked [L, in, out] weight quantized one layer at a time, so
    the f32 working copy is one layer, not the whole stack."""
    qtype = fp8_dtype() if mode == "fp8" else torch.int8
    wq = torch.empty(w.shape, dtype=qtype, device=w.device)
    s = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        wq[i], s[i] = quantize_weight(w[i], in_axis=0, mode=mode)
    return wq, s


def _int_mm_layout(name: str, wq: torch.Tensor) -> torch.Tensor:
    """A w8a8 weight as `_int_mm` reads it fastest: the same shape and
    values, stored column-major (each [in, out] matrix). On the card its
    widths must be multiples of 8, or the product would refuse them at
    the first tick."""
    if wq.is_cuda and any(n % _INT_MM_WIDTH for n in wq.shape[-2:]):
        raise ValueError(
            f"quant_mode='w8a8' on the card needs {name}'s widths "
            f"{tuple(wq.shape[-2:])} to be multiples of {_INT_MM_WIDTH} "
            f"(the int8 product, torch._int_mm)")
    return wq.transpose(-2, -1).contiguous().transpose(-2, -1)


def quantize_llama_params(params: Dict, mode: str, manifest=None) -> Dict:
    """A new params dict with the matmul weights quantized for ``mode``
    ("" returns ``params`` as it is). Embedding and norm leaves are
    kept. `w8a8` reads its activation scales from ``manifest`` (a
    :class:`~.manifest.QuantManifest`) and needs one."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r} not in {QUANT_MODES}")
    if not mode:
        return params
    if mode == "w8a8" and manifest is None:
        raise ValueError(
            "quant_mode='w8a8' quantizes activations with STATIC "
            "calibrated scales; run inference.quant.calibrate over a "
            "sample workload and pass the manifest")
    if "blocks" not in params or "lm_head" not in params:
        raise ValueError("quantize_llama_params expects the stacked LLaMA "
                         "params dict (init_params output)")
    blocks = dict(params["blocks"])
    missing = [n for n in WEIGHT_NAMES if n not in blocks]
    if missing:
        raise NotImplementedError(
            f"quantized transform covers dense LLaMA blocks; params are "
            f"missing {missing}")
    dev = params["lm_head"].device
    for name in WEIGHT_NAMES:
        wq, blocks[name + "_s"] = _quantize_stack(blocks.pop(name), mode)
        if mode == "w8a8":
            wq = _int_mm_layout(name, wq)
            blocks[name + "_a"] = torch.tensor(
                manifest.act_scales[name], dtype=torch.float32, device=dev)
        blocks[name + "_q"] = wq
    out = {k: v for k, v in params.items() if k != "lm_head"}
    out["blocks"] = blocks
    lm_q, out["lm_head_s"] = quantize_weight(params["lm_head"], in_axis=0,
                                             mode=mode)
    if mode == "w8a8":
        lm_q = _int_mm_layout("lm_head", lm_q)
        out["lm_head_a"] = torch.tensor(manifest.act_scales["lm_head"][0],
                                        dtype=torch.float32, device=dev)
    out["lm_head_q"] = lm_q
    return out


def quantize_act(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """w8a8's int8 activations: clip(round(h / a * 127)) in f32, with the
    static absmax `a` of the manifest (the reference's order: divide,
    then scale)."""
    return torch.clamp(torch.round(h.float() / a * QMAX),
                       -QMAX, QMAX).to(torch.int8)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 @ wq [K, N] int8 -> [..., N] int32, exact. On the
    card fewer than INT_MM_MIN_ROWS rows are padded with zero rows for
    `torch._int_mm` and cut off after; the padding changes no other
    row's sums."""
    lead, K = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, K)
    R = x2.shape[0]
    if x2.is_cuda and R < INT_MM_MIN_ROWS:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, INT_MM_MIN_ROWS - R))
    return torch._int_mm(x2, wq)[:R].reshape(*lead, wq.shape[-1])


def matmul_param(h: torch.Tensor, tree: Dict, name: str) -> torch.Tensor:
    """``h @ tree[name]`` in h's type: the fp leaf when it exists, else
    the quantized product its leaves call for (the module docstring).
    ``tree`` is one layer's leaves ([in, out] / [1, out] / scalar) or the
    root dict (the lm_head)."""
    wq = tree.get(name + "_q")
    if wq is None:
        return h @ tree[name].to(h.dtype)
    s = tree[name + "_s"]
    a = tree.get(name + "_a")
    if wq.dtype == torch.int8 and a is not None:              # w8a8
        acc = int8_matmul(quantize_act(h, a), wq)
        y = acc.float() * ((a * s) / (QMAX * QMAX))
        return y.to(h.dtype)
    qmax = QMAX if wq.dtype == torch.int8 else FP8_MAX        # weight-only
    acc = h @ wq.to(h.dtype)
    return acc * (s / qmax).to(h.dtype)


def ffn_param(h: torch.Tensor, lp: Dict) -> torch.Tensor:
    """A layer's SwiGLU FFN on h: the fused kernel for fp and w8 leaves
    (`apply_ffn`), the reference's chain of `matmul_param` products for
    w8a8 and fp8 leaves (`FF.params_kind` None)."""
    if FF.params_kind(lp) is not None:
        return FF.apply_ffn(h, lp)
    gate = (torch.nn.functional.silu(matmul_param(h, lp, "w1"))
            * matmul_param(h, lp, "w3"))
    return matmul_param(gate, lp, "w2")
