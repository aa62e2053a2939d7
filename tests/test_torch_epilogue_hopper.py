"""The GEMM epilogue's kernels (A8) held against their plain version, on
the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, never at import). bf16 operands that TMA can address run the
wgmma kernel (64 x 64 tiles three to an SM up to 64 rows, 128-row tiles
above; TMA's zero fill carries ragged m, k and n, the stores mask);
others run the mma.sync kernel; f32 runs CUDA-core FMAs. The cases walk
the corners of that split: rows 1, 8, 63, 65 and 300 against the 64- and
128-row tiles, widths that are multiples of 8 but not of 64, every
activation with and without a bias, the decode tile across many column
blocks, and operands whose rows or bases TMA cannot address. Every case
reruns the kernel and requires bit-identical output, and holds the
launch count by path to what `epilogue_path` said before the launch.
This file imports neither jax nor the reference:

    python -m pytest tests/test_torch_epilogue_hopper.py -m gpu --noconftest -q

Tolerances, elementwise, as in `tests/test_torch_ffn_hopper.py`:
|got - want| <= rtol |want| + atol; bf16 rounds once to bf16 on both
sides after f32 sums: rtol 2^-7 (one bf16 ulp of |want|), atol 1e-3 x
the RMS of want; f32: rtol 1e-5, atol rtol x that RMS.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

_BF16 = 2 ** -7


def _close(got, want, rtol):
    want = want.float()
    rms = want.square().mean().sqrt().item()
    atol = (1e-3 if rtol == _BF16 else rtol) * rms
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, dtype, m, k, n, bias, seed=0):
    g = torch.Generator().manual_seed(seed + m * 7 + k * 13 + n)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    y = (torch.randn(k, n, generator=g) / k ** 0.5).to(dev, dtype)
    b = torch.randn(n, generator=g).to(dev, dtype) if bias else None
    return x, y, b


def _run(x, y, b, act, rtol, path):
    assert FF.epilogue_path(x, y) == path
    FF.KERNEL_EPILOGUE.reset()
    out = FF.fused_gemm_epilogue_fwd(x, y, b, act)
    assert out.dtype == x.dtype and out.shape == (x.shape[0], y.shape[1])
    _close(out, FF.fused_gemm_epilogue_plain(x, y, b, act), rtol)
    assert torch.equal(FF.fused_gemm_epilogue_fwd(x, y, b, act), out)
    assert FF.KERNEL_EPILOGUE.paths == {path: 2}


@pytest.mark.parametrize("act,bias", [("none", False), ("relu", True),
                                      ("gelu", True), ("silu", False),
                                      ("sigmoid", True)])
@pytest.mark.parametrize("k,n", [(72, 40), (264, 520)])
@pytest.mark.parametrize("m", [1, 8, 63, 65, 300])
def test_wgmma_matches_plain(cuda, m, k, n, act, bias):
    x, y, b = _operands(cuda, torch.bfloat16, m, k, n, bias)
    _run(x, y, b, act, _BF16, "wgmma")


@pytest.mark.parametrize("m,k,n", [(8, 512, 4160), (64, 1024, 8192),
                                   (512, 1024, 1536)])
def test_wgmma_many_tiles(cuda, m, k, n):
    """The decode tile over 65 and 128 column blocks, and 128-row tiles
    over a grouped walk of 4 x 6 (128 x 256) tiles."""
    x, y, b = _operands(cuda, torch.bfloat16, m, k, n, True)
    _run(x, y, b, "gelu", _BF16, "wgmma")


@pytest.mark.parametrize("m,k,n", [(100, 70, 36), (37, 21, 19),
                                   (130, 257, 136), (64, 64, 12)])
def test_rows_tma_cannot_address_take_mma(cuda, m, k, n):
    x, y, b = _operands(cuda, torch.bfloat16, m, k, n, True)
    _run(x, y, b, "silu", _BF16, "mma")


@pytest.mark.parametrize("which", ["x", "y"])
def test_misaligned_base_takes_mma(cuda, which):
    """An operand one element into its storage cannot be a TMA map: the
    predicate sends it to the mma.sync kernel before any launch."""
    x, y, b = _operands(cuda, torch.bfloat16, 96, 128, 192, True)
    t = {"x": x, "y": y}[which]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=cuda)[1:].view(t.shape).copy_(t)
    ops = {"x": x, "y": y, which: shifted}
    _run(ops["x"], ops["y"], b, "relu", _BF16, "mma")


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (65, 72, 40), (37, 21, 19)])
def test_f32_takes_fma(cuda, m, k, n):
    x, y, b = _operands(cuda, torch.float32, m, k, n, True)
    _run(x, y, b, "gelu", 1e-5, "fma")
