"""`chip_smoke.py`'s eager phases (8a `EAGER_DISPATCH`, 8b `LENET`) on
the CPU, as `tests/test_torch_smokes.py` runs the smokes' twins: the
same functions the card runs, with the eager API pointed at the CPU, the
dispatch loop cut from 2,000 to 200 additions and LeNet's timed loop to
4 steps. The times are not held here (the
card's run prints them); the checks are: the dispatch cache's hit rate
1.0 and no plan built after warm-up, the port's sum bit-equal to bare
torch's, finite LeNet losses through the pipelined loop, and the
card-against-CPU loss comparison's machinery (CPU against CPU here,
equal).
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()


@pytest.fixture(autouse=True)
def _restore_place():
    yield
    port_place._current[0] = None


def test_eager_dispatch_phase_on_cpu(capsys, monkeypatch):
    assert chip_smoke.EAGER_N == 2000       # the card's count
    monkeypatch.setattr(chip_smoke, "EAGER_N", 200)
    out = chip_smoke.eager_dispatch(torch, np, torch.device("cpu"))
    assert out["hit_rate"] is None and out["traces"] == 0
    assert out["dispatches"] == chip_smoke.EAGER_N == 200
    assert out["cache"]["dispatches"] == chip_smoke.EAGER_N + 1
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("EAGER_DISPATCH ")]
    assert json.loads(line[0].split(" ", 1)[1])["hit_rate"] is None


def test_lenet_phase_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "LENET_STEPS", 4)
    out = chip_smoke.lenet_phase(torch, np, torch.device("cpu"))
    assert out["batch"] == 64 and out["steps"] == 4
    assert np.isfinite(out["last_loss"])
    assert out["card_losses"] == out["cpu_losses"]     # CPU on both sides
    assert len(out["cpu_losses"]) == chip_smoke.LENET_AGREE_STEPS
    assert out["hit_rate"] is None and out["traces"] == 0
