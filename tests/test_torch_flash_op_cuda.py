"""The dense flash-attention ops (`flash_attn`, `flash_attn_qkvpacked`,
`memory_efficient_attention`, `ops/kernels/tail_alias.py`) on the card:
kernels A1 and A2 against their plain versions, and their launches.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture). It imports neither jax nor the reference:

    python -m pytest tests/test_torch_flash_op_cuda.py --noconftest -q

Tolerances as `tests/test_torch_cuda.py`'s: bf16 rtol 2^-7 with atol
1e-3 x the RMS of want; f32 rtol 1e-5 (forward) and 1e-4 (gradients),
atol rtol x that RMS.
"""
import pytest
import torch

from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.ops.cuda import flash_attention as FA
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


@pytest.mark.parametrize("dtype,fwd_tol,grad_tol",
                         [(torch.float32, 1e-5, 1e-4),
                          (torch.bfloat16, _BF16, _BF16)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_runs_a1_and_a2(cuda, dtype, fwd_tol, grad_tol, causal):
    """One call forward and backward: A1 and A2 once each, the output
    held to A1's plain version and the gradients to A2's plain version
    on the inputs A2 got (q, k, v, A1's o and lse, dO)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 200, 4, 64, device=cuda, dtype=dtype,
                           generator=g).requires_grad_() for _ in range(3))
    do = torch.randn(2, 200, 4, 64, device=cuda, dtype=dtype, generator=g)
    FA.KERNEL_FWD.reset()
    FA.KERNEL_BWD.reset()
    out = _C_ops.flash_attn(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert FA.KERNEL_FWD.launches == 1 and FA.KERNEL_BWD.launches == 1
    scale = 1.0 / 64 ** 0.5
    qt, kt, vt, dot = (t.detach().transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    o_ref, _ = FA.flash_attention_fwd_plain(qt, kt, vt, causal, scale)
    o_k, lse_k = FA.flash_attention_fwd(qt, kt, vt, causal, scale)
    assert torch.equal(o_k.transpose(1, 2), out.detach())
    want_g = FA.flash_attention_bwd_plain(qt, kt, vt, o_k, lse_k, dot,
                                          causal, scale)
    _close(out.detach(), o_ref.transpose(1, 2), fwd_tol)
    for got_g, w in zip(grads, want_g):
        _close(got_g, w.transpose(1, 2), grad_tol)


def test_masked_and_dropout_calls_launch_nothing(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    mask = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    FA.KERNEL_FWD.reset()
    _C_ops.flash_attn(q, q, q, attn_mask=mask)
    _C_ops.flash_attn(q, q, q, dropout=0.1)
    _C_ops.memory_efficient_attention(q, q, q, bias=mask)
    assert FA.KERNEL_FWD.launches == 0
    _C_ops.flash_attn_qkvpacked(torch.stack([q, q, q], 2))
    _C_ops.memory_efficient_attention(q, q, q)
    assert FA.KERNEL_FWD.launches == 2


def test_float16_and_wide_heads_raise(cuda):
    h = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        _C_ops.flash_attn(h, h, h)
    w = torch.zeros(1, 8, 2, 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        _C_ops.flash_attn(w, w, w)
