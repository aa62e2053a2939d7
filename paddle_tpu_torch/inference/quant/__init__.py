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
mode. The port has no flags module yet, so nothing reads the
reference's `FLAGS_quant_*`: the engine's arguments are the switch.
"""
from __future__ import annotations

from typing import Optional, Union

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
           "fp8_dtype", "resolve_manifest", "QUANT_MODES", "WEIGHT_NAMES",
           "ACT_NAMES", "QMAX", "FP8_MAX", "MANIFEST_VERSION"]


def resolve_manifest(manifest: Union[QuantManifest, str, None] = None
                     ) -> Optional[QuantManifest]:
    """A QuantManifest as it is, a path loaded, None (or an empty path)
    as no manifest."""
    if manifest is None or isinstance(manifest, QuantManifest):
        return manifest
    return load_manifest(str(manifest)) if str(manifest) else None
