"""Boundaries of the port package `paddle_tpu_torch`.

- It never imports jax or the reference package `paddle_tpu` (whose
  import also turns on jax's x64 mode), and neither do its card script
  `chip_smoke.py` and its tools `tools/*_torch.py` (the smokes' twins
  among them): walked
  with `ast`, so a lazy import inside a function is caught too.
- Its entry points run on the card unless the caller asks for the CPU:
  without a CUDA device and without `device="cpu"` they raise.
- Every port test file pins torch to one intra-op thread at import
  (`tests/torch_threads.py`), and the package itself never sets
  torch's thread count.
"""
import ast
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import PagedServingEngine
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

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


def test_every_port_test_file_pins_one_torch_thread():
    # at import, through tests/torch_threads.py; and the package never
    # changes torch's global thread count
    tests = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(tests) >= 53
    missing = []
    for path in tests:
        calls = [n for n in ast.parse(path.read_text()).body
                 if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                 and getattr(n.value.func, "id", None) == "one_torch_thread"]
        if not calls:
            missing.append(path.name)
    assert not missing, missing
    for path in sorted(PKG.rglob("*.py")):
        assert "set_num_threads" not in path.read_text(), path


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


def test_only_item_9s_ops_wait():
    # since the collective layer (ROADMAP item 7a) every collective name is
    # registered; what still waits is sparse and the geometric tail
    from paddle_tpu_torch import _C_ops  # noqa: F401  (loads every module)
    from paddle_tpu_torch.ops.kernels._util import WAITING
    assert sorted(WAITING) == sorted([
        "coalesce", "fake_quantize_dequantize_abs_max", "graph_send_recv",
        "graph_send_ue_recv", "graph_send_uv", "indices", "mask_as",
        "masked_matmul", "segment_max", "segment_mean", "segment_min",
        "segment_sum", "sparse_coo_tensor", "to_dense", "to_sparse_coo",
        "to_sparse_csr", "values"])
    assert {f._waiting_item for f in WAITING.values()} == {9}
