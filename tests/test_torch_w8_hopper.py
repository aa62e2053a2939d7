"""The int8-weight fused FFN's tensor-core kernels (A6, bf16 x) held
against their plain version, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, never at import). bf16 x runs gate/up, down and reduce on the
wgmma core with the product swapped (out^T = W^T x^T): the int8 weight
tiles come in by TMA and are widened into the register A operand, the
token rows are the wgmma's N. The cases walk the corners: rows 1, 8, 37,
64, 65 and 300 against the 8- and 64-row tiles (`w8_tile`), widths that
are multiples of 16 but not of 64 (d = 144, f = 1040: TMA's zero fill
carries the depth tails and the stores mask) beside llama-test's 64 /
128, and the down product split over d_ff by `w8_splits`. Every case
reruns the kernel and requires bit-identical output, and counts its
launch on the wgmma path. The wrapper refuses operands TMA cannot read.
This file imports neither jax
nor the reference:

    python -m pytest tests/test_torch_w8_hopper.py -m gpu --noconftest -q

Tolerance, elementwise, as in `tests/test_torch_ffn_hopper.py`: bf16
outputs round once on both sides after f32 sums: rtol 2^-7 (one bf16 ulp
of |want|), atol 1e-3 x the RMS of want.
"""
import pytest
import torch

from paddle_tpu_torch.inference.quant import quantize_weight
from paddle_tpu_torch.ops.cuda import fused_ffn as FF

pytestmark = pytest.mark.gpu

_BF16 = 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, rows, d, f):
    """Seeded bf16 x [rows, d] and one layer's w8 leaves in A6's order."""
    g = torch.Generator().manual_seed(rows * 1000 + d + f)
    x = torch.randn(rows, d, generator=g).to(dev, torch.bfloat16)
    leaves = []
    for shape in ((d, f), (d, f), (f, d)):
        q, s = quantize_weight(0.1 * torch.randn(*shape, generator=g), 0)
        leaves += [q.to(dev), s.to(dev)]
    return x, leaves


@pytest.mark.parametrize("d,f", [(64, 128), (144, 1040), (256, 640)])
@pytest.mark.parametrize("rows", [1, 8, 37, 64, 65, 300])
def test_bf16_matches_plain(cuda, rows, d, f):
    x, leaves = _operands(cuda, rows, d, f)
    FF.KERNEL_W8.reset()
    out = FF.fused_ffn_w8(x, *leaves)
    assert out.dtype == torch.bfloat16 and out.shape == (rows, d)
    want = FF.fused_ffn_w8_plain(x, *leaves).float()
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(out.float(), want, rtol=_BF16,
                               atol=1e-3 * rms)
    assert torch.equal(FF.fused_ffn_w8(x, *leaves), out)
    assert FF.KERNEL_W8.paths == {"wgmma": 2}


def test_leading_dims(cuda):
    x, leaves = _operands(cuda, 12, 64, 128)
    out = FF.fused_ffn_w8(x.reshape(3, 4, 64), *leaves)
    assert out.shape == (3, 4, 64)
    assert torch.equal(out.reshape(12, 64), FF.fused_ffn_w8(x, *leaves))


@pytest.mark.parametrize("which", ["x", "w1_q", "w2_q"])
def test_misaligned_operand_raises(cuda, which):
    """An operand whose address is not 16-byte aligned (a view one
    element into its storage) is refused before any launch."""
    x, leaves = _operands(cuda, 8, 64, 128)
    ops = {"x": x, "w1_q": leaves[0], "w2_q": leaves[4]}
    t = ops[which]
    ops[which] = torch.empty(t.numel() + 1, dtype=t.dtype,
                             device=cuda)[1:].view(t.shape).copy_(t)
    leaves[0], leaves[4] = ops["w1_q"], ops["w2_q"]
    FF.KERNEL_W8.reset()
    with pytest.raises(ValueError, match="16-byte"):
        FF.fused_ffn_w8(ops["x"], *leaves)
    assert FF.KERNEL_W8.launches == 0
