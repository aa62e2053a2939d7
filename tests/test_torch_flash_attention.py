"""Port kernels A1 and A2 (flash attention forward and backward) held
against the reference.

The port's plain versions — what its wrappers run for CPU tensors — and
the reference's Pallas kernels in interpret mode get the same numpy
inputs, f32, with grouped-query heads (H = 4, KV = 2) and T = 384, which
the reference cuts into three 128-row tiles. Tolerances: the forward (o
and lse) sums in another order, rtol 1e-5 with atol 1e-6 for values near
0; the backward goes through the port's autograd Function (the FA-2
formulas from lse) against `jax.grad` of the reference with a
non-trivial cotangent, and differences of f32 rounding in p feed three
more products: rtol 1e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops.cuda import flash_attention as FA


def _inputs(B, H, KV, T, hd, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, T, hd).astype(np.float32)
    k = rs.randn(B, KV, T, hd).astype(np.float32)
    v = rs.randn(B, KV, T, hd).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2)])
def test_fwd_plain_matches_reference_kernel(causal, H, KV):
    q, k, v = _inputs(1, H, KV, 384, 16, seed=H + KV + int(causal))
    scale = 0.25
    o_ref, lse_ref = JFA._fwd(*(jnp.asarray(a) for a in (q, k, v)), scale,
                              causal, interpret=True)
    o, lse = FA.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5,
                               atol=1e-6)
    # the reference broadcasts lse over 8 lanes; the port keeps [B, H, T]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_autograd_matches_reference_grad(causal):
    B, H, KV, T, hd = 2, 4, 2, 384, 16
    q, k, v = _inputs(B, H, KV, T, hd, seed=7 + int(causal))
    # BTHD, the public layout of both packages
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    ct = np.random.RandomState(3).randn(B, T, H, hd).astype(np.float32)

    def ref_loss(q_, k_, v_):
        o = JFA.flash_attention(q_, k_, v_, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(ct))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((o * torch.from_numpy(ct)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_plain_backward_is_the_fa2_form_of_autograd():
    """The plain backward (formulas from lse) equals autograd through the
    plain forward, on a ragged length and a single kv head."""
    q, k, v = _inputs(1, 3, 1, 45, 8, seed=11)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = FA.flash_attention_fwd_plain(tq, tk, tv, True, 0.3)
    do = torch.from_numpy(np.random.RandomState(5).randn(*o.shape)
                          .astype(np.float32))
    want = torch.autograd.grad(o, (tq, tk, tv), do)
    got = FA.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                       o.detach(), lse.detach(), do, True, 0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_supported_and_rejections():
    assert FA.supported(32, 32, 128) and FA.supported(32, 8, 128)
    assert FA.supported(4, 2, 8)
    assert not FA.supported(32, 5, 128)       # groups must be whole
    assert not FA.supported(32, 32, 136)      # past the 128-wide tiles
    assert not FA.supported(32, 32, 12)       # 16-byte loads
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="segment ids"):
        FA.flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8),
                           kv_segment_ids=torch.zeros(1, 8))
