"""`ops/ops.yaml`, the manifest of the op surface: port of
`paddle_tpu/ops/schema.py`.

The port keeps its own copy of the manifest, byte-equal to the
reference's (`tests/test_torch_surface.py` holds the two files equal).
Each entry names an op and its `args:` signature; `test:` and `opt_out:`
are the reference harness's fields, kept as they are.
`tools/gen_op_bindings_torch.py` writes `ops/generated_bindings.py`
from it, and the public op surface (`_C_ops`, the Tensor methods, the
top-level op names) is built from that module.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict

MANIFEST_PATH = Path(__file__).resolve().parent / "ops.yaml"

_ENTRY = re.compile(r"^- op: (\S+)\s*$")
_FIELD = re.compile(r"^  (\w+): (.*)$")


def load_manifest(path: Path = MANIFEST_PATH) -> Dict[str, Dict[str, Any]]:
    """Parse the manifest into {op: {"args": str, "test": dict or None,
    "opt_out": str or None}}. The format is a small YAML subset (flat
    entries, one-line fields), read without a yaml library."""
    out: Dict[str, Dict[str, Any]] = {}
    cur = None
    for line in Path(path).read_text().splitlines():
        m = _ENTRY.match(line)
        if m:
            cur = {"args": "", "test": None, "opt_out": None}
            out[m.group(1)] = cur
            continue
        if cur is None:
            continue
        f = _FIELD.match(line)
        if not f:
            continue
        key, val = f.group(1), f.group(2).strip()
        if key == "args":
            cur["args"] = val
        elif key == "test":
            cur["test"] = ast.literal_eval(val)
        elif key == "opt_out":
            cur["opt_out"] = val
    return out
