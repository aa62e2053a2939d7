"""Quantized inference of the port — counterpart of
`paddle_tpu/inference/quant/`, weight-only int8 (`w8`) and the
calibration the int8 paged KV cache needs:

- ``calibrate`` (calibrate.py): one observer pass over sample batches
  -> a versioned, CRC'd :class:`QuantManifest` of weight, activation
  and KV scales;
- ``quantize_llama_params`` / ``matmul_param`` (transform.py): the w8
  weight transform and the product the engine runs on it;
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
from .transform import (QMAX, QUANT_MODES, WEIGHT_NAMES, matmul_param,
                        quantize_llama_params, quantize_weight)

__all__ = ["calibrate", "QuantManifest", "save_manifest", "load_manifest",
           "model_signature", "quantize_llama_params", "quantize_weight",
           "matmul_param", "resolve_manifest", "QUANT_MODES",
           "WEIGHT_NAMES", "ACT_NAMES", "QMAX", "MANIFEST_VERSION"]


def resolve_manifest(manifest: Union[QuantManifest, str, None] = None
                     ) -> Optional[QuantManifest]:
    """A QuantManifest as it is, a path loaded, None (or an empty path)
    as no manifest."""
    if manifest is None or isinstance(manifest, QuantManifest):
        return manifest
    return load_manifest(str(manifest)) if str(manifest) else None
