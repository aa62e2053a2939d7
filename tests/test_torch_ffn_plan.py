"""What of the fused FFN's tensor-core redesign runs on the CPU: A3's own
split plan for its down product (`ffn_splits`; A6's are `w8_splits`,
`tests/test_torch_w8_plan.py`, and for f32 x `splits`, held by
`test_torch_fused_ffn.py::test_supported_and_split_plan`), and the
wrappers' refusal of operands that TMA cannot read.
The kernels themselves run only on the card
(`tests/test_torch_ffn_hopper.py`)."""
import math

import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from torch_threads import one_torch_thread

one_torch_thread()

_SMS = 132


@pytest.mark.parametrize("rows,d,f,want", [
    (8, 4096, 11008, 4),        # decode tick: 64 column blocks, 4 slices
    (64, 4096, 11008, 4),       # prefill chunk: one 64-row tile as well
    (65, 4096, 11008, 4),       # one 128-row tile: 32 blocks, 4 slices
    (300, 4096, 11008, 1),      # 96 blocks, one an SM: no split
    (4096, 4096, 11008, 1),     # training rows: 1,024 blocks, no split
    (1, 136, 520, 9),           # one slice per 64-deep tile of d_ff
    (1, 64, 128, 2),
])
def test_a3_split_plan(rows, d, f, want):
    assert FF.ffn_splits(rows, d, f) == want


@pytest.mark.parametrize("rows", [1, 8, 63, 64, 65, 128, 300, 4096])
@pytest.mark.parametrize("d,f", [(64, 128), (136, 520), (4096, 11008),
                                 (8192, 28672)])
def test_a3_split_plan_keeps_the_launch_resident(rows, d, f):
    """At least one slice and at most one per 64-deep tile (and 16); a
    split launch never holds more blocks than the card keeps resident (64
    x 64 tiles two to an SM, 128 x 128 one)."""
    n = FF.ffn_splits(rows, d, f)
    assert 1 <= n <= min(16, math.ceil(f / 64))
    tile, per_sm = (64, 2) if rows <= 64 else (128, 1)
    blocks = math.ceil(rows / tile) * math.ceil(d / tile)
    if n > 1:
        assert blocks * n <= _SMS * per_sm


def test_tma_refuses_misaligned_operands():
    buf = torch.zeros(8 * 136 + 8, dtype=torch.bfloat16)
    FF._tma_ready("fused_ffn", buf[:8 * 136].view(8, 136))
    FF._tma_ready("fused_ffn", buf[8:8 + 8 * 136].view(8, 136))   # +16 B
    with pytest.raises(ValueError, match="16-byte"):
        FF._tma_ready("fused_ffn", buf[1:1 + 8 * 136].view(8, 136))
    rows = torch.zeros(8, 140, dtype=torch.bfloat16)[:, :136]    # 280 B rows
    with pytest.raises(ValueError, match="16-byte"):
        FF._tma_ready("fused_ffn_bwd", rows)
