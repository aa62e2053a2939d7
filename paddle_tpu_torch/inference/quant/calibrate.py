"""PTQ calibration over a sample workload — the port of
`paddle_tpu/inference/quant/calibrate.py` `calibrate` (:47).

Runs the LLaMA forward in f32, layer by layer, with absmax observers at
every quantized matmul's input and at the post-rope K and the V
projections, and returns a :class:`~.manifest.QuantManifest`:

- ``weight_scales``: per-output-channel absmax per layer (recorded for
  audit; the transform recomputes them from the weights);
- ``act_scales``: per-layer absmax of each matmul's input (the static
  activation scales `w8a8` will read);
- ``kv_scales``: per-(layer, kv head) absmax of the post-rope keys and
  of the values, the int8 paged cache's scales (keys after rope, as the
  pages store them).

Attention and the FFN go through `models/llama.py`'s `attention` and
`ffn`: on the card kernels A1 and A3, in f32 as the reference computes.
A3 keeps the FFN's gate on chip, so the observer at w2's input
recomputes the gate with two plain products. The projections are plain
products. The result lives on the host; calibration runs once per
deployment.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from ...models import llama as L
from .manifest import QuantManifest, model_signature
from .transform import WEIGHT_NAMES

__all__ = ["calibrate", "ACT_NAMES", "WEIGHT_NAMES"]

# each matmul of a block has an activation observer at its input
ACT_NAMES = WEIGHT_NAMES + ("lm_head",)
_EPS = 1e-8


def _absmax(x: torch.Tensor) -> float:
    return float(x.abs().max())


@torch.no_grad()
def calibrate(cfg: L.LlamaConfig, params: Dict,
              batches: Iterable[Sequence[Sequence[int]]]) -> QuantManifest:
    """Observe scales over ``batches`` (an iterable of [B, T] int token
    arrays) and return the manifest. Runs on the device that holds
    ``params``."""
    dev = params["embed"].device
    nl, nh, nkv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
    act = {n: np.zeros((nl,), np.float64) for n in WEIGHT_NAMES}
    act_lm = 0.0
    kv_k = np.zeros((nl, nkv), np.float64)
    kv_v = np.zeros((nl, nkv), np.float64)
    n_batches = 0

    for tokens in batches:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=dev)
        if tokens.dim() == 1:
            tokens = tokens[None]
        B, T = tokens.shape
        n_batches += 1
        x = params["embed"][tokens].float()
        cos, sin = L.rope_cos_sin(torch.arange(T, device=dev), hd,
                                  cfg.rope_theta)
        for li in range(nl):
            lp = {k: v[li].float() for k, v in params["blocks"].items()}
            h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
            a = _absmax(h)
            for n in ("wq", "wk", "wv"):
                act[n][li] = max(act[n][li], a)
            q = (h @ lp["wq"]).reshape(B, T, nh, hd)
            k = (h @ lp["wk"]).reshape(B, T, nkv, hd)
            v = (h @ lp["wv"]).reshape(B, T, nkv, hd)
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
            kv_k[li] = np.maximum(kv_k[li], k.abs().amax(dim=(0, 1, 3))
                                  .cpu().numpy())
            kv_v[li] = np.maximum(kv_v[li], v.abs().amax(dim=(0, 1, 3))
                                  .cpu().numpy())
            o = L.attention(q, k, v).reshape(B, T, nh * hd)
            act["wo"][li] = max(act["wo"][li], _absmax(o))
            x = x + o @ lp["wo"]
            h2 = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            a2 = _absmax(h2)
            act["w1"][li] = max(act["w1"][li], a2)
            act["w3"][li] = max(act["w3"][li], a2)
            gate = torch.nn.functional.silu(h2 @ lp["w1"]) * (h2 @ lp["w3"])
            act["w2"][li] = max(act["w2"][li], _absmax(gate))
            x = x + L.ffn(h2, lp)
        xf = L.rms_norm(x, params["final_norm"].float(), cfg.rms_eps)
        act_lm = max(act_lm, _absmax(xf))
    if n_batches == 0:
        raise ValueError("calibrate needs at least one sample batch")

    def channel_absmax(w, axis):
        # abs and max are exact in any float type: reduce, then widen
        return np.maximum(w.abs().amax(dim=axis).float().cpu().numpy(),
                          _EPS).tolist()

    weight_scales = {n: channel_absmax(params["blocks"][n], 1)
                     for n in WEIGHT_NAMES}                # [L, out]
    weight_scales["lm_head"] = channel_absmax(params["lm_head"], 0)
    act_scales = {n: np.maximum(act[n], _EPS).tolist() for n in WEIGHT_NAMES}
    act_scales["lm_head"] = [max(act_lm, _EPS)]
    kv_scales = {"k": np.maximum(kv_k, _EPS).tolist(),
                 "v": np.maximum(kv_v, _EPS).tolist()}
    return QuantManifest(model=model_signature(cfg),
                         weight_scales=weight_scales,
                         act_scales=act_scales, kv_scales=kv_scales)
