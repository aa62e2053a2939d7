"""What of the GEMM epilogue's (A8's) Hopper redesign runs on the CPU: the
pure-Python predicate that picks its kernel from dtype, shape, strides and
addresses before a launch (`epilogue_path`), and the tiling its wgmma
kernel takes at decode rows, which must keep a launch's blocks resident.
The kernels themselves run only on the card
(`tests/test_torch_epilogue_hopper.py`)."""
import math

import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from torch_threads import one_torch_thread

one_torch_thread()

_SMS = 132
_SMEM_PER_SM = 233472       # bytes of shared memory an H100 SM holds
_RESERVED = 1024            # bytes the card keeps back a block


def _operands(m, k, n, dtype=torch.bfloat16):
    return torch.zeros(m, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)


@pytest.mark.parametrize("m,k,n", [
    (4096, 4096, 12288),    # qkv
    (4096, 4096, 22016),    # gate_up
    (4096, 11008, 4096),    # down
    (4096, 4096, 4096),     # wo
    (8, 4096, 22016),       # a decode tick's rows
    (100, 72, 40),          # off every tile, rows still 16-byte multiples
    (1, 8, 8),
])
def test_llama_shapes_take_wgmma(m, k, n):
    assert FF.epilogue_path(*_operands(m, k, n)) == "wgmma"


@pytest.mark.parametrize("m,k,n", [
    (100, 70, 36),          # 140-byte rows of x, 72-byte rows of y
    (37, 21, 19),
    (130, 257, 136),        # x's rows odd, y's fine
    (64, 64, 12),           # y's rows 24 bytes
])
def test_rows_tma_cannot_address_take_mma(m, k, n):
    assert FF.epilogue_path(*_operands(m, k, n)) == "mma"


@pytest.mark.parametrize("which", ["x", "y"])
def test_misaligned_base_takes_mma(which):
    """A contiguous view one element into its storage: rows of 16-byte
    multiples, a base that is not 16-byte aligned."""
    x, y = _operands(64, 128, 256)
    t = {"x": x, "y": y}[which]
    shifted = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    ops = {"x": x, "y": y, which: shifted}
    assert FF.epilogue_path(ops["x"], ops["y"]) == "mma"
    sixteen = torch.zeros(t.numel() + 8, dtype=t.dtype)[8:].view(t.shape)
    ops[which] = sixteen                       # 16 bytes in: aligned again
    assert FF.epilogue_path(ops["x"], ops["y"]) == "wgmma"


def test_f32_takes_fma():
    assert FF.epilogue_path(*_operands(4096, 4096, 4096,
                                       torch.float32)) == "fma"


def test_kernel_counts_launches_by_path():
    k = FF.KERNEL_EPILOGUE
    k.reset()
    k.count("wgmma")
    k.count("wgmma")
    k.count("mma")
    assert k.launches == 3 and k.paths == {"wgmma": 2, "mma": 1}
    k.reset()
    assert k.launches == 0 and k.paths == {}


def _smem(rows, cols):
    """Dynamic shared memory of a wgmma block: four 64-deep stages of
    rows / 64 x boxes and cols / 64 y boxes (8 KB each), the ring's
    barriers and the 1024-byte alignment slack."""
    return 4 * (rows // 64 + cols // 64) * 8192 + 2 * 8 * 4 + 1024


@pytest.mark.parametrize("m", [1, 8, 64, 65, 4096])
def test_tiles_fit_their_blocks_an_sm(m):
    rows, cols, per_sm = FF.epilogue_tile(m)
    assert rows == (64 if m <= 64 else 128)
    assert per_sm * (_smem(rows, cols) + _RESERVED) <= _SMEM_PER_SM
    assert _smem(rows, cols) <= 232448           # a block's own limit


@pytest.mark.parametrize("m,n", [(8, 22016), (1, 12288), (64, 4096),
                                 (8, 11008), (8, 4096)])
def test_decode_tiling_keeps_the_launch_resident(m, n):
    """At decode rows every block of a launch is resident at once (one
    wave)."""
    rows, cols, per_sm = FF.epilogue_tile(m)
    blocks = math.ceil(m / rows) * math.ceil(n / cols)
    assert blocks <= _SMS * per_sm


def test_decode_tiling_balances_the_sms():
    """Why 64 columns at LLaMA-7B's widest projection (8 x 4096 @ 4096 x
    22016, bound by y's bytes): 64 x 128 tiles give 172 blocks, so 40 SMs
    stream two blocks' bytes while 92 stream one (the busiest SM 1.53 x
    the mean); 64 x 64 tiles give 344, three or two an SM (1.15 x)."""
    rows, cols, per_sm = FF.epilogue_tile(8)
    imbalance = {}
    for c in (cols, 128):
        blocks = math.ceil(22016 / c)
        imbalance[c] = math.ceil(blocks / _SMS) / (blocks / _SMS)
    assert cols == 64 and math.ceil(22016 / cols) == 344
    assert imbalance[64] < 1.2 < 1.5 < imbalance[128]
