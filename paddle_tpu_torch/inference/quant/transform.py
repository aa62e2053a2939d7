"""Quantized model transform — the port of
`paddle_tpu/inference/quant/transform.py`, weight-only int8 (`w8`).

``quantize_llama_params`` (reference :67) rewrites the parameter dict
the serving engine runs: every block matmul weight (wq/wk/wv/wo/w1/w3/
w2) and the lm_head become two leaves, with the reference's names and
shapes —

- ``<name>_q``  int8 weights, same [L, in, out] layout ([in, out] for
  the lm_head);
- ``<name>_s``  f32 per-output-channel absmax scales [L, 1, out]
  ([1, out] for the lm_head); they stay f32 whatever type the fp
  leaves are stored in (`models.llama.params_from_numpy` and the
  engine keep every `*_s` leaf f32).

``matmul_param(h, tree, name)`` (reference :117) is the one product the
engine calls for q/k/v/o and the lm_head: ``h @ w`` for fp leaves,
``(h @ w_q.to(h.dtype)) * (s / 127).to(h.dtype)`` for w8, the
reference's order. It is a plain large product outside any kernel, as
the reference leaves it to XLA; the int8 -> compute-type cast of the
weight is a plain op too. The FFN's int8 weights go to kernel A6 as
int8 instead (`ops/cuda/fused_ffn.py` `apply_ffn`).

`w8a8` (static int8 activations, an int8 x int8 product) and `fp8`
(weight-only float8_e4m3) have no Pallas kernel in the reference and
come with a later slice of the port: here they raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["quantize_llama_params", "quantize_weight", "matmul_param",
           "QUANT_MODES", "WEIGHT_NAMES", "QMAX"]

QMAX = 127.0
QUANT_MODES = ("", "w8", "w8a8", "fp8")
WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def quantize_weight(w: torch.Tensor, in_axis: int):
    """(int8 weights, f32 absmax scales with keepdims along `in_axis`),
    the reference's `_quantize_stack` (:54) in f32: clip(round(w / s *
    127)), torch.round rounding half to even as jnp.round does."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=in_axis, keepdim=True), min=1e-8)
    wq = torch.clamp(torch.round(w / s * QMAX), -QMAX, QMAX)
    return wq.to(torch.int8), s


def _quantize_stack(w: torch.Tensor):
    """A stacked [L, in, out] weight quantized one layer at a time, so
    the f32 working copy is one layer, not the whole stack."""
    wq = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        wq[i], s[i] = quantize_weight(w[i], in_axis=0)
    return wq, s


def quantize_llama_params(params: Dict, mode: str, manifest=None) -> Dict:
    """A new params dict with the matmul weights quantized for ``mode``
    ("" returns ``params`` as it is). Embedding and norm leaves are
    kept. ``manifest`` is the reference's argument, read by `w8a8`
    only."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r} not in {QUANT_MODES}")
    if not mode:
        return params
    if mode in ("w8a8", "fp8"):
        raise NotImplementedError(
            f"quant_mode={mode!r} comes with a later slice of the port "
            f"(the reference serves it through plain XLA products, with no "
            f"Pallas kernel); use 'w8' (weight-only int8)")
    if "blocks" not in params or "lm_head" not in params:
        raise ValueError("quantize_llama_params expects the stacked LLaMA "
                         "params dict (init_params output)")
    blocks = dict(params["blocks"])
    missing = [n for n in WEIGHT_NAMES if n not in blocks]
    if missing:
        raise NotImplementedError(
            f"quantized transform covers dense LLaMA blocks; params are "
            f"missing {missing}")
    for name in WEIGHT_NAMES:
        blocks[name + "_q"], blocks[name + "_s"] = \
            _quantize_stack(blocks.pop(name))
    out = {k: v for k, v in params.items() if k != "lm_head"}
    out["blocks"] = blocks
    out["lm_head_q"], out["lm_head_s"] = quantize_weight(params["lm_head"],
                                                         in_axis=0)
    return out


def matmul_param(h: torch.Tensor, tree: Dict, name: str) -> torch.Tensor:
    """``h @ tree[name]`` in h's type: the fp leaf when it exists, else
    the weight-only int8 product. ``tree`` is one layer's leaves
    ([in, out] / [1, out]) or the root dict (the lm_head)."""
    wq = tree.get(name + "_q")
    if wq is None:
        return h @ tree[name].to(h.dtype)
    if wq.dtype != torch.int8 or (name + "_a") in tree:
        raise NotImplementedError(
            f"{name}: only weight-only int8 (w8) leaves are served")
    acc = h @ wq.to(h.dtype)
    return acc * (tree[name + "_s"] / QMAX).to(h.dtype)
