"""Port kernel A5 (paged attention) held against the reference.

The port's plain PyTorch version — what its wrapper runs for CPU
tensors — and the reference's Pallas kernel in interpret mode get the
same numpy inputs: ragged mixed rows, `max_q = 1` decode rows, GQA with
G = 2, pad rows and an idle slot, pages past the live length holding
garbage, and -1 table entries. f32 throughout; sums run in another
order, so outputs agree to 1e-5 (atol and rtol), not bitwise.

The serving-attention layer around the kernel (rope, page append, q
packing) is held against the reference's `block_multihead_attention_`
on its Pallas path the same way, caches included. The int8-page mode has
its own file, `test_torch_quant_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu.ops.kernels.serving_attention import \
    block_multihead_attention_ as jax_bmha
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.cuda import paged_attention as PA
from paddle_tpu_torch.ops.kernels import serving_attention as SA
from torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(max_q, past, this, group=2, kv=2, hd=16, bs=4, nb=24, mb=6,
          seed=0):
    rs = np.random.RandomState(seed)
    B = len(past)
    q = rs.randn(B, kv, max_q * group, hd).astype(np.float32)
    kc = rs.randn(nb, kv, bs, hd).astype(np.float32)   # garbage everywhere
    vc = rs.randn(nb, kv, bs, hd).astype(np.float32)
    tables = np.full((B, mb), -1, np.int32)
    free = list(rs.permutation(nb))
    for b in range(B):
        need = -(-(past[b] + this[b]) // bs)
        extra = 1 if b == 0 else 0    # a mapped page past the live length
        for p in range(need + extra):
            tables[b, p] = free.pop()
    return (q, kc, vc, tables, np.asarray(past, np.int32),
            np.asarray(this, np.int32), group)


def _both(q, kc, vc, tables, past, this, group):
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    ref = np.asarray(JPA.paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(past), jnp.asarray(this), group,
        scale, interpret=True))
    t = torch.from_numpy
    out = PA.paged_attention(t(q), t(kc), t(vc), t(tables), t(past),
                             t(this), group, scale).numpy()
    return out, ref


@pytest.mark.parametrize("max_q,past,this,group", [
    (3, [5, 0, 9, 3], [3, 2, 1, 0], 2),      # ragged mixed, idle slot
    (1, [6, 0, 13, 2], [1, 1, 1, 0], 2),     # decode launch
    (4, [0, 7, 2], [4, 1, 3], 1),            # MHA, pad rows
])
def test_plain_matches_reference_kernel(max_q, past, this, group):
    out, ref = _both(*_case(max_q, past, this, group=group))
    np.testing.assert_allclose(out, ref, **TOL)
    # dead rows (t >= this) are exactly 0 in both
    for b, n in enumerate(this):
        assert np.all(out[b, :, n * group:] == 0.0)


def test_supported_gate():
    assert PA.supported(32, 32, 128, 16)          # LLaMA-7B geometry
    assert PA.supported(32, 8, 128, 16)           # GQA G = 4
    assert not PA.supported(32, 8, 100, 16)       # hd not a multiple of 8
    assert not PA.supported(6, 4, 128, 16)        # ragged GQA group
    assert not PA.supported(8, 8, 512, 16)        # tile over shared memory


def _bmha_case(decode, seed=3):
    rs = np.random.RandomState(seed)
    H, KV, hd, bs, nb, B, mb, S = 4, 2, 8, 4, 24, 3, 6, 32
    if decode:
        past, this = np.array([5, 9, 0], np.int32), np.array([1, 1, 0],
                                                             np.int32)
        tok = B
    else:
        past, this = np.array([0, 6, 3], np.int32), np.array([5, 1, 4],
                                                             np.int32)
        tok = 12                                   # 10 valid + 2 pad tokens
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum(this)
    tables = np.full((B, mb), -1, np.int32)
    free = list(rs.permutation(nb))
    for b in range(B):
        for p in range(-(-(past[b] + this[b]) // bs)):
            tables[b, p] = free.pop()
    qkv = rs.randn(tok, (H + 2 * KV) * hd).astype(np.float32)
    kc = rs.randn(nb, KV, bs, hd).astype(np.float32)
    vc = rs.randn(nb, KV, bs, hd).astype(np.float32)
    cos, sin = JL.rope_cos_sin(jnp.arange(S), hd, 10000.0)
    rope = np.array(jnp.stack([jnp.concatenate([cos, cos], -1)[None],
                               jnp.concatenate([sin, sin], -1)[None]]))
    return qkv, kc, vc, past, this, cu, tables, rope, bs


@pytest.mark.parametrize("decode", [False, True])
def test_serving_attention_matches_reference(decode):
    qkv, kc, vc, past, this, cu, tables, rope, bs = _bmha_case(decode)
    B = tables.shape[0]
    o_ref, _, kc_ref, vc_ref = jax_bmha.__wrapped__(
        jnp.asarray(qkv), jnp.asarray(kc), jnp.asarray(vc),
        jnp.zeros((B,), jnp.int32), jnp.asarray(past), jnp.asarray(this),
        cu_seqlens_q=jnp.asarray(cu), block_tables=jnp.asarray(tables),
        rope_emb=jnp.asarray(rope), use_neox_style=True, block_size=bs,
        use_pallas="decode" if decode else True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    meta = SA.paged_metadata(cu, past, this, tables, qkv.shape[0], bs,
                             torch.from_numpy(rope),
                             max_q=1 if decode else None)
    o = SA.paged_block_attention(torch.from_numpy(qkv), k_t, v_t, meta)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(kc_ref), **TOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(vc_ref), **TOL)


def test_serving_attention_refuses_int8_pages():
    """Int8 pages need all four cache scale tensors: one alone is refused
    (the reference's partial-scales check, `serving_attention.py:422`)."""
    qkv, kc, vc, past, this, cu, tables, rope, bs = _bmha_case(False)
    meta = SA.paged_metadata(cu, past, this, tables, qkv.shape[0], bs,
                             torch.from_numpy(rope))
    scales = torch.ones(2)
    with pytest.raises(ValueError, match="all four cache scale tensors"):
        SA.paged_block_attention(
            torch.from_numpy(qkv), torch.from_numpy(kc.astype(np.int8)),
            torch.from_numpy(vc.astype(np.int8)), meta,
            cache_k_quant_scales=scales)
