"""Boundaries of the port package `paddle_tpu_torch`.

- It never imports jax or the reference package `paddle_tpu` (whose
  import also turns on jax's x64 mode), and neither do its card script
  `chip_smoke.py` and its tools `tools/*_torch.py` (the smokes' twins
  among them): walked
  with `ast`, so a lazy import inside a function is caught too.
- Its entry points run on the card unless the caller asks for the CPU:
  without a CUDA device and without `device="cpu"` they raise.
"""
import ast
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import PagedServingEngine
from paddle_tpu_torch.models import llama as L

PKG = Path(paddle_tpu_torch.__file__).parent


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    # the package, its card script at the repo root and the port's tools
    # (the smokes' twins among them)
    tools = sorted((PKG.parent / "tools").glob("*_torch.py"))
    assert len([t for t in tools if t.name.endswith("_smoke_torch.py")]) == 5
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"] + tools
    assert len(files) >= 36
    bad = []
    for path in files:
        for name in _imported_roots(ast.parse(path.read_text())):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "paddle_tpu"):
                bad.append(f"{path.relative_to(PKG.parent)}: {name}")
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = L.CONFIGS["llama-test"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.init_params(cfg, torch.Generator())
    params = L.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.resolve()
    assert not paddle_tpu_torch.available()


def test_cpu_request_builds_an_engine():
    cfg = L.CONFIGS["llama-test"]
    params = L.init_params(cfg, torch.Generator(), device="cpu")
    eng = PagedServingEngine(cfg, params, device="cpu", max_len=64)
    assert eng.device.type == "cpu"
    assert eng._key_cache.device.type == "cpu"
