"""Port kernel A7 (sampler prep) held against the reference.

The port's plain version — what its wrapper runs for CPU tensors — and
the reference's Pallas `fused_sample_prep` in interpret mode get the
same numpy logits, temperatures and top-p values, with top-k off and on,
at V = 97 and at LLaMA-3's 128,256. The argmax must match exactly, and
the pattern of -inf entries too (at 128,256 except where an entry's
exclusive prefix mass lies within 1e-4 of top_p: the two frameworks sum
the probabilities in their own orders); the kept (finite) values are the
same division on both sides and match to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.ops.pallas import fused_sample as JFS
from paddle_tpu_torch.ops.cuda import fused_sample as FS
from torch_threads import one_torch_thread

one_torch_thread()


@pytest.mark.parametrize("top_k", [0, 7])
def test_plain_matches_reference_kernel(top_k):
    rs = np.random.RandomState(10 + top_k)
    B, V = 5, 97
    logits = (2.0 * rs.randn(B, V)).astype(np.float32)
    temps = np.array([0.7, 1.0, 1e-9, 1.3, 0.9], np.float32)
    top_ps = np.array([0.9, 1.0, 0.5, 0.3, 0.05], np.float32)
    m_ref, a_ref = JFS.fused_sample_prep(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps), top_k,
        interpret=True)
    m_ref, a_ref = np.asarray(m_ref), np.asarray(a_ref)
    masked, amax = FS.fused_sample_prep(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ps), top_k)
    masked, amax = masked.numpy(), amax.numpy()
    np.testing.assert_array_equal(amax.astype(np.int64),
                                  a_ref.astype(np.int64))
    np.testing.assert_array_equal(np.isneginf(masked), np.isneginf(m_ref))
    fin = np.isfinite(m_ref)
    np.testing.assert_allclose(masked[fin], m_ref[fin], rtol=1e-6, atol=0)
    # the masks did something: top-p (and top-k) dropped entries in some
    # rows, and every row keeps its argmax
    assert np.isneginf(masked).sum() > 0
    assert np.all(np.isfinite(masked[np.arange(B), amax]))


@pytest.mark.parametrize("top_k", [0, 50])
def test_plain_matches_reference_kernel_at_llama3_vocab(top_k):
    # B * V = 256,512, inside the reference kernel's gate (B * V <= 524,288)
    rs = np.random.RandomState(20 + top_k)
    B, V = 2, 128256
    logits = (3.0 * rs.randn(B, V)).astype(np.float32)
    temps = np.array([0.8, 1.0], np.float32)
    top_ps = np.array([0.9, 0.95], np.float32)
    m_ref, a_ref = JFS.fused_sample_prep(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps), top_k,
        interpret=True)
    m_ref, a_ref = np.asarray(m_ref), np.asarray(a_ref)
    masked, amax = FS.fused_sample_prep(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ps), top_k)
    masked, amax = masked.numpy(), amax.numpy()
    np.testing.assert_array_equal(amax.astype(np.int64),
                                  a_ref.astype(np.int64))
    # torch and XLA sum 128k f32 probabilities in their own orders: the
    # -inf pattern may differ where an entry's exclusive prefix mass lies
    # within 1e-4 of top_p, and nowhere else
    t = torch.from_numpy
    chip_smoke.sample_boundary(torch, f"plain top_k={top_k}", t(masked),
                               t(np.array(m_ref)), t(logits), t(temps),
                               t(top_ps), top_k)
    fin = np.isfinite(m_ref) & np.isfinite(masked)
    np.testing.assert_allclose(masked[fin], m_ref[fin], rtol=1e-6, atol=0)
    assert np.isneginf(masked).sum() > 0


def test_supported_gate():
    # one cluster a row, streamed past what it keeps resident: no cap
    for vocab in (1, 97, 32000, 32768, 32769, 128256, 152064, 2 ** 20,
                  1048583, 2 ** 31 - 1):
        assert FS.supported(vocab)
    assert not FS.supported(0)
