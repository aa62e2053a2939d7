"""Port kernels A3 and A4 (fused SwiGLU FFN forward and backward) held
against the reference.

The port's plain versions — what its wrappers run for CPU tensors — and
the reference's Pallas `fused_ffn` in interpret mode get the same numpy
inputs, with one d_ff block (d_ff <= 512) and several (d_ff = 1024 runs
as two 512-wide blocks in the reference). f32 math on both sides, in
another summation order: the forward rtol 1e-5 (atol 1e-6 for outputs
near 0); the gradients through the port's autograd Function against
`jax.grad`, rtol 1e-5 (atol 1e-5 for gradients near 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_ffn as JFF
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from torch_threads import one_torch_thread

one_torch_thread()


def _inputs(rows, d, f, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    w1 = (0.1 * rs.randn(d, f)).astype(np.float32)
    w3 = (0.1 * rs.randn(d, f)).astype(np.float32)
    w2 = (0.1 * rs.randn(f, d)).astype(np.float32)
    return x, w1, w3, w2


@pytest.mark.parametrize("rows,d,f", [(8, 64, 128), (24, 32, 1024)])
def test_plain_matches_reference_kernel(rows, d, f):
    x, w1, w3, w2 = _inputs(rows, d, f, seed=rows)
    ref = np.asarray(JFF.fused_ffn(*(jnp.asarray(a) for a in (x, w1, w3, w2)),
                                   interpret=True))
    out = FF.fused_ffn(*(torch.from_numpy(a) for a in (x, w1, w3, w2)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_leading_dims_and_dtype_round_trip():
    x, w1, w3, w2 = _inputs(6, 32, 64, seed=1)
    xt = torch.from_numpy(x).reshape(2, 3, 32).to(torch.bfloat16)
    out = FF.fused_ffn(xt, *(torch.from_numpy(a) for a in (w1, w3, w2)))
    assert out.shape == (2, 3, 32) and out.dtype == torch.bfloat16


def test_supported_and_split_plan():
    assert FF.supported(4096, 11008)
    assert not FF.supported(4096, 11004)          # 16-byte weight loads
    # decode rows: 128 column blocks, split d_ff so ~4 blocks per SM
    assert FF.splits(8, 4096, 11008) == 5
    # prefill chunk: twice the row blocks, fewer splits
    assert FF.splits(64, 4096, 11008) == 3
    # never more slices than 64-deep tiles of d_ff
    assert FF.splits(1, 64, 128) == 2


@pytest.mark.parametrize("rows,d,f", [(8, 64, 128), (24, 32, 1024)])
def test_backward_matches_reference_grad(rows, d, f):
    """A4: the port's registered op (A3 forward, A4 backward; their
    plain versions on the CPU) against `jax.grad` of the reference's
    `fused_ffn` in interpret mode, with one d_ff block and two, under a
    non-trivial cotangent. f32 both sides in another summation order:
    rtol 1e-5, atol 1e-5 for gradients near 0."""
    import jax

    x, w1, w3, w2 = _inputs(rows, d, f, seed=rows + 1)
    ct = np.random.RandomState(9).randn(rows, d).astype(np.float32)

    def ref_loss(*args):
        out = JFF.fused_ffn(*args, interpret=True)
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w1, w3, w2)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w3, w2)]
    out = FF.fused_ffn_op(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_backward_plain_types_follow_inputs():
    x, w1, w3, w2 = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(6, 32, 64, seed=2))
    dx, dw1, dw3, dw2 = FF.fused_ffn_bwd(x, w1, w3, w2, torch.ones_like(x))
    assert dx.shape == x.shape and dw1.shape == w1.shape
    assert dw2.shape == w2.shape
    assert {t.dtype for t in (dx, dw1, dw3, dw2)} == {torch.bfloat16}
