"""The port's twins of the serving smokes (`tools/*_smoke_torch.py`) on
the CPU.

Each twin keeps its reference tool's tiny config, trace, constants and
check names and imports `paddle_tpu_torch` only
(`tests/test_torch_package.py` walks it). Here each runs with
`device="cpu"`, where every kernel wrapper takes its plain version, and
every check that does not compare times must hold; the card runs the
twins whole, times included (`python3 tools/<name>_smoke_torch.py`).
"""
import importlib.util
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread

one_torch_thread()

TOOLS = Path(__file__).resolve().parents[1] / "tools"
TWINS = ("serving", "router", "spec", "disagg", "quant")
# checks that compare two times: CPU timings at this scale are noise
TIMED_CHECKS = {"throughput_paged_ge_dense", "throughput_router_ge_0p9x_share"}


def _load(name):
    path = TOOLS / f"{name}_smoke_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_smoke_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("twin", TWINS)
def test_twin_checks_hold_on_cpu(twin):
    out = _load(twin).run(device="cpu")
    assert out["device"] == "cpu"
    checks = out["checks"]
    assert checks, "a twin with no checks"
    failed = [k for k, ok in checks.items()
              if not ok and k not in TIMED_CHECKS]
    assert not failed, (failed, out)
