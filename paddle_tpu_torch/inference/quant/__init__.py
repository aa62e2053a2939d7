"""Quantized inference of the port — counterpart of
`paddle_tpu/inference/quant/`: the modes `w8` (weight-only int8),
`w8a8` (static int8 activations, int8 x int8 products) and `fp8`
(weight-only float8_e4m3fn), and the calibration that the int8 paged KV
cache and `w8a8` need:

- ``calibrate`` (calibrate.py): one observer pass over sample batches
  -> a versioned, CRC'd :class:`QuantManifest` of weight, activation
  and KV scales;
- ``quantize_llama_params`` / ``matmul_param`` / ``ffn_param``
  (transform.py): the weight transform, the products the engines run
  on its leaves and the FFN's route (fused kernel or plain chain);
- the manifest file (manifest.py), in the reference's format: a file
  saved by either package loads in the other.

The int8 pages themselves live where the pages live: quantize-on-append
in `ops/kernels/serving_attention.py`, the per-page scale arrays in
`inference/serving/engine.py`, and the int8 read in kernel A5's int8
mode. `FLAGS_quant_mode`, `FLAGS_quant_kv_cache` and
`FLAGS_quant_manifest` are defined here as in the reference: the engine
and the predictor read them when their `quant_mode` / `quant_kv` /
`quant_manifest` arguments are None, and an explicit argument always
wins (`resolve_quant_mode`, `resolve_manifest`).
"""
from __future__ import annotations

from typing import Optional, Union

from ...core import flags
from .calibrate import ACT_NAMES, calibrate
from .manifest import (MANIFEST_VERSION, QuantManifest, load_manifest,
                       model_signature, save_manifest)
from .transform import (FP8_MAX, QMAX, QUANT_MODES, WEIGHT_NAMES,
                        ffn_param, fp8_dtype, int8_matmul, matmul_param,
                        quantize_act, quantize_llama_params,
                        quantize_weight)

__all__ = ["calibrate", "QuantManifest", "save_manifest", "load_manifest",
           "model_signature", "quantize_llama_params", "quantize_weight",
           "matmul_param", "ffn_param", "quantize_act", "int8_matmul",
           "fp8_dtype", "resolve_quant_mode", "resolve_manifest",
           "QUANT_MODES", "WEIGHT_NAMES",
           "ACT_NAMES", "QMAX", "FP8_MAX", "MANIFEST_VERSION"]


flags.define_flag(
    "quant_mode", "",
    "Inference weight quantization for LLMPredictor/PagedServingEngine "
    "when not passed explicitly: '' serves fp weights, 'w8' weight-only "
    "int8 with per-channel scales, 'w8a8' adds static int8 activations "
    "(needs a calibration manifest), 'fp8' weight-only float8_e4m3")
flags.define_flag(
    "quant_kv_cache", False,
    "Store paged serving KV-cache pages as int8 with per-page, per-head "
    "scales: quantize-on-append, dequantize inside the paged attention "
    "kernel. Needs a calibration manifest for the KV scales")
flags.define_flag(
    "quant_manifest", "",
    "Path to a quantization manifest (inference.quant.calibrate + "
    "save_manifest) holding calibrated activation and KV scales; loaded "
    "at predictor/engine construction when quantization needs it")


def resolve_quant_mode(mode: Optional[str] = None) -> str:
    """An explicit mode wins; None falls back to FLAGS_quant_mode."""
    if mode is None:
        mode = str(flags.flag_value("quant_mode"))
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r} not in {QUANT_MODES}")
    return mode


def resolve_manifest(manifest: Union[QuantManifest, str, None] = None
                     ) -> Optional[QuantManifest]:
    """A QuantManifest as it is, a path loaded; None falls back to
    FLAGS_quant_manifest, and an empty path is no manifest."""
    if isinstance(manifest, QuantManifest):
        return manifest
    path = str(manifest) if manifest is not None \
        else str(flags.flag_value("quant_manifest"))
    return load_manifest(path) if path else None
