"""Versioned, CRC'd quantization manifest — a copy of
`paddle_tpu/inference/quant/manifest.py` (`QuantManifest` :50,
`validate_for` :63, `model_signature` :76, `save_manifest` :86,
`load_manifest` :108) with the same file format, so a manifest saved by
either package loads in the other. The reference's metric emits are
left out; they come with the port's observability.

Layout (JSON, one object)::

    {"format": "paddle-tpu-quant-manifest", "version": 1,
     "crc32": <int over canonical payload json>,
     "payload": {"model": {...structural signature...},
                 "weight_scales": {"wq": [L][out], ..., "lm_head": [out]},
                 "act_scales":    {"wq": [L], ..., "lm_head": [1]},
                 "kv_scales":     {"k": [L][KV], "v": [L][KV]}}}

All scales are absmax values: dequant = q * absmax / 127, quant =
x * 127 / absmax.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = ["QuantManifest", "save_manifest", "load_manifest",
           "model_signature", "MANIFEST_VERSION", "MANIFEST_FORMAT"]

MANIFEST_VERSION = 1
MANIFEST_FORMAT = "paddle-tpu-quant-manifest"


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


@dataclass
class QuantManifest:
    """Calibrated scales for one model. ``model`` is the structural
    signature (layer/head/dim counts) checked by :meth:`validate_for`."""
    model: Dict[str, int]
    weight_scales: Dict[str, Any] = field(default_factory=dict)
    act_scales: Dict[str, List[float]] = field(default_factory=dict)
    kv_scales: Dict[str, Any] = field(default_factory=dict)
    version: int = MANIFEST_VERSION

    def payload(self) -> dict:
        return {"model": self.model, "weight_scales": self.weight_scales,
                "act_scales": self.act_scales, "kv_scales": self.kv_scales}

    def validate_for(self, cfg) -> None:
        """Raise ValueError when this manifest was calibrated for a
        different model structure than ``cfg``."""
        want = model_signature(cfg)
        got = {k: int(v) for k, v in self.model.items()}
        if got != want:
            diffs = {k: (got.get(k), want[k]) for k in want
                     if got.get(k) != want[k]}
            raise ValueError(
                f"quant manifest was calibrated for a different model: "
                f"mismatched fields (manifest, config) = {diffs}")


def model_signature(cfg) -> Dict[str, int]:
    return {"num_layers": int(cfg.num_layers),
            "hidden_size": int(cfg.hidden_size),
            "intermediate_size": int(cfg.intermediate_size),
            "num_heads": int(cfg.num_heads),
            "num_kv_heads": int(cfg.num_kv_heads),
            "head_dim": int(cfg.head_dim),
            "vocab_size": int(cfg.vocab_size)}


def save_manifest(manifest: QuantManifest, path: str) -> str:
    """Atomically write the manifest (tmp file + os.replace)."""
    payload = manifest.payload()
    doc = {"format": MANIFEST_FORMAT, "version": int(manifest.version),
           "crc32": zlib.crc32(_canonical(payload)), "payload": payload}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".quant_manifest_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_manifest(path: str) -> QuantManifest:
    """Load and verify a manifest. Raises ValueError on a format,
    version or CRC mismatch."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"quant manifest {path!r} unreadable: {e}") from e
    if not isinstance(doc, dict) or doc.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path!r} is not a {MANIFEST_FORMAT} file")
    if int(doc.get("version", -1)) != MANIFEST_VERSION:
        raise ValueError(
            f"quant manifest {path!r} has version {doc.get('version')}; "
            f"this build reads version {MANIFEST_VERSION} — re-run "
            f"calibration")
    payload = doc.get("payload") or {}
    crc = zlib.crc32(_canonical(payload))
    if crc != int(doc.get("crc32", -1)):
        raise ValueError(
            f"quant manifest {path!r} failed its CRC check "
            f"(stored {doc.get('crc32')}, computed {crc}): the file is "
            f"corrupt or was hand-edited — re-run calibration")
    return QuantManifest(model=payload.get("model", {}),
                         weight_scales=payload.get("weight_scales", {}),
                         act_scales=payload.get("act_scales", {}),
                         kv_scales=payload.get("kv_scales", {}),
                         version=int(doc["version"]))
