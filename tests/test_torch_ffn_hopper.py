"""The fused SwiGLU FFN's tensor-core kernels (A3 forward, A4 backward)
held against their plain versions, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, never at import). The bf16 kernels run every product as wgmma
from TMA-filled, 128-byte-swizzled tiles; these cases walk the corners of
that design: row counts against the 64- and 128-row tiles (1, 8, 63, 65,
300: one consumer warpgroup up to 64 rows, two above), widths that are
multiples of 8 but not of 64 (d = 136, f = 520: TMA's zero fill carries
the depth tails and the stores are masked) beside multiples of 64 and
128, and, at up to 64 rows, the down product split over d_ff (nine
slices at f = 520). f32 takes the CUDA-core kernels. Every case reruns
the kernel and requires bit-identical outputs, and counts one launch a
call. The wrappers refuse operands TMA cannot take. This file imports
neither jax nor the reference, so it runs on a machine without them:

    python -m pytest tests/test_torch_ffn_hopper.py -m gpu --noconftest -q

Tolerances, elementwise (`_close`, as in `tests/test_torch_cuda.py`):
|got - want| <= rtol |want| + atol. bf16 outputs round once to bf16 on
both sides after f32 sums: rtol 2^-7 (one bf16 ulp of |want|), atol 1e-3
x the RMS of want. f32: rtol 1e-4 for the FFN's deep sums and the
gradients, atol rtol x the RMS of want.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

_BF16 = 2 ** -7          # one bf16 ulp of |want|

ROWS = (1, 8, 63, 65, 300)
WIDTHS = ((136, 520), (256, 640))     # ragged against 64; 128-multiples
DTYPES = ((torch.bfloat16, _BF16), (torch.float32, 1e-4))


def _close(got, want, rtol):
    """|got - want| <= rtol |want| + atol elementwise; atol is 1e-3 x the
    RMS of want for bf16 (rtol 2^-7), rtol x that RMS for f32."""
    want = want.float()
    rms = want.square().mean().sqrt().item()
    atol = (1e-3 if rtol == _BF16 else rtol) * rms
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, dtype, rows, d, f):
    """Seeded x, do [rows, d] and weights w1, w3 [d, f], w2 [f, d]."""
    g = torch.Generator().manual_seed(rows * 1000 + d + f)
    x, do = (torch.randn(rows, d, generator=g).to(dev, dtype)
             for _ in range(2))
    w1, w3 = ((0.1 * torch.randn(d, f, generator=g)).to(dev, dtype)
              for _ in range(2))
    w2 = (0.1 * torch.randn(f, d, generator=g)).to(dev, dtype)
    return x, do, w1, w3, w2


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("d,f", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_forward_matches_plain(cuda, dtype, rtol, rows, d, f):
    x, _, w1, w3, w2 = _operands(cuda, dtype, rows, d, f)
    FF.KERNEL.launches = 0
    out = FF.fused_ffn(x, w1, w3, w2)
    assert out.dtype == dtype and out.shape == (rows, d)
    _close(out, FF.fused_ffn_plain(x, w1, w3, w2), rtol)
    assert torch.equal(FF.fused_ffn(x, w1, w3, w2), out)
    assert FF.KERNEL.launches == 2


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("d,f", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_backward_matches_plain(cuda, dtype, rtol, rows, d, f):
    x, do, w1, w3, w2 = _operands(cuda, dtype, rows, d, f)
    FF.KERNEL_BWD.launches = 0
    got = FF.fused_ffn_bwd(x, w1, w3, w2, do)
    want = FF.fused_ffn_bwd_plain(x, w1, w3, w2, do)
    for name, a, b in zip(("dx", "dw1", "dw3", "dw2"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        _close(a, b, rtol)
    again = FF.fused_ffn_bwd(x, w1, w3, w2, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert FF.KERNEL_BWD.launches == 2


@pytest.mark.parametrize("which", ["x", "w2"])
def test_misaligned_operand_raises(cuda, which):
    """An operand whose address is not 16-byte aligned (a view one
    element into its storage) is refused before any launch."""
    x, do, w1, w3, w2 = _operands(cuda, torch.bfloat16, 8, 136, 520)
    ops = {"x": x, "w2": w2}
    t = ops[which]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:]
    ops[which] = shifted.view(t.shape).copy_(t)
    FF.KERNEL.launches = FF.KERNEL_BWD.launches = 0
    with pytest.raises(ValueError, match="16-byte"):
        FF.fused_ffn(ops["x"], w1, w3, ops["w2"])
    with pytest.raises(ValueError, match="16-byte"):
        FF.fused_ffn_bwd(ops["x"], w1, w3, ops["w2"], do)
    assert FF.KERNEL.launches == FF.KERNEL_BWD.launches == 0
